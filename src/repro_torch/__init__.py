"""PyTorch/CUDA port of the PGBSC subgraph counter (``src/repro`` is the
JAX reference it is held against).

The slice ported so far is the PGBSC count path: ``repro_torch.api.count``
and ``repro_torch.core.engines.CountingEngine`` walk the template's plan
through hand-written CUDA kernels for the BSR SpMM, the eMA and the fused
SpMM->eMA (``csrc/``). Entry points run on the card unless the caller asks
for ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version. See ``ROADMAP.md`` for what is still to port.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
