"""PyTorch/CUDA port of the PGBSC subgraph counter (``src/repro`` is the
JAX reference it is held against).

Ported so far:

* the count path (``repro_torch.api.count``, ``count_many``,
  ``compile_query``, ``motif_features``) on
  ``repro_torch.core.engines.CountingEngine``, whose PGBSC engine walks the
  template's plan through hand-written CUDA kernels for the SpMMs, the
  eMA, the fused SpMM->eMA and its shared-passive group, and the chunked
  eMA's accumulate (``csrc/``), with colorset chunking and vertex
  reordering; its FASCIA/PFASCIA baselines run torch's ops;
* the block autotuner over the kernels' launch shapes and the kernel
  roofline (``kernels/autotune.py``, ``analysis/roofline.py``);
* the fault-tolerant estimator runner and the resilience stack
  (``core/runner.py``, ``resilience/``), and observability (``obs/``);
* the multi-tenant counting service, its HTTP front end and the
  ``serve`` launcher (``service/``, ``launch/serve.py``, ``graph/io.py``);
* distributed PGBSC on ``torch.distributed`` (``core/distributed.py``,
  ``launch/{mesh,ranks}.py``);
* the GNN models the motif features feed — GraphSAGE, PNA, GatedGCN and
  NequIP (``models/``) — the architecture registry (``configs/``), AdamW
  with int8 gradient compression (``optim/``), synthetic GNN batches
  (``data/``), and the reference's weights carried in (``interop.py``).

Entry points run on the card unless the caller asks for
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version. See ``ROADMAP.md`` for what is still to port.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
