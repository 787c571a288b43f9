"""PyTorch/CUDA port of the PGBSC subgraph counter (``src/repro`` is the
JAX reference it is held against).

Ported so far: the count path (``repro_torch.api.count``, ``count_many``,
``compile_query``) on ``repro_torch.core.engines.CountingEngine``, whose
PGBSC engine walks the template's plan through hand-written CUDA kernels
for the SpMMs, the eMA, the fused SpMM->eMA and its shared-passive group
(``csrc/``), and whose FASCIA/PFASCIA baselines run torch's ops; and the
fault-tolerant estimator runner (``repro_torch.core.runner``). Entry
points run on the card unless the caller asks for ``device="cpu"``, where
every kernel wrapper runs its plain PyTorch version. See ``ROADMAP.md``
for what is still to port.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
