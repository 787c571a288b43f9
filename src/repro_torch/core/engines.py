"""The PGBSC counting engine on PyTorch (paper §4.3-4.5).

Combination-major ``(B, C, N)`` count tables, one BSR SpMM ``Y = M_p @ A``
per distinct passive child and an eMA per plan node — or both in one fused
kernel launch where the passive child has a single consumer and the card's
shared-memory fit model admits it. The walk is the shared
:class:`~repro_torch.core.executor.PlanExecutor`; the kernels are
``kernels/{spmm,ema,fused}``, which launch CUDA on the card and run their
plain PyTorch versions on the CPU.

A port of the JAX package's ``core/engines.py`` for ``engine="pgbsc"`` and
one template. The FASCIA/PFASCIA engines, the other SpMM backends, vertex
reordering, multi-template bundles and colorset chunking are not ported
yet and raise ``NotImplementedError`` (see ``ROADMAP.md``).
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch

from repro_torch.core import colorsets as cs
from repro_torch.core import executor as pexec
from repro_torch.core.templates import ExecutionPlan, as_template
from repro_torch.device import CARD_DTYPES, accum_dtype, resolve_device
from repro_torch.graph.coloring import batch_colorings
from repro_torch.graph.structure import Graph
from repro_torch.kernels.ema import ops as ema_ops
from repro_torch.kernels.fused import ops as fused_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing

__all__ = ["CountingEngine"]

_TODO = "not ported yet (ROADMAP.md, Queue 1)"


class CountingEngine:
    """Counts colorful embeddings of one template for given colorings.

    :meth:`count_colorful` takes an ``(n,)`` coloring and returns the sum
    over the root table (= alpha x #colorful copies) and the root table;
    :meth:`count_colorful_batch` takes ``(B, n)``; :meth:`estimate` runs
    the color-coding estimator over colorings drawn on the engine's device
    from the same stream as the JAX package (``graph/coloring.py``).

    ``memory_budget_bytes`` becomes the coloring batch size through the
    executor's memory model (fused nodes are charged no neighbor-sum
    table); ``batch_size`` overrides the derived batch. ``device=None``
    runs on CUDA and raises without a card; ``device="cpu"`` runs the
    kernels' plain versions.
    """

    def __init__(self, g: Graph, template, engine: str = "pgbsc",
                 spmm_method: str = "bsr", plan: str | None = None,
                 dtype=torch.float32, batch_size: int | None = None,
                 memory_budget_bytes: int | None = None,
                 fuse_spmm_ema: bool = True, reorder: str | None = None,
                 device=None):
        if engine != "pgbsc":
            raise NotImplementedError(f"engine {engine!r} is {_TODO}")
        if spmm_method != "bsr":
            raise NotImplementedError(
                f"SpMM backend {spmm_method!r} is {_TODO}; the port's "
                "backend is 'bsr'")
        if reorder:
            raise NotImplementedError(f"reorder={reorder!r} is {_TODO}")
        if isinstance(template, (list, tuple)):
            raise NotImplementedError(
                f"multi-template bundles are {_TODO}; pass one template")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype not in CARD_DTYPES:
            raise TypeError(f"the card runs {sorted(map(str, CARD_DTYPES))} "
                            f"tables, got {dtype}")
        self.g = g
        self.template = as_template(template)
        self.engine = engine
        self.k = self.template.k
        self.dtype = dtype
        self.memory_budget_bytes = memory_budget_bytes
        plan_name = plan or "plain"
        self.plan: ExecutionPlan = {
            "plain": self.template.plan, "dedup": self.template.plan_dedup,
            "optimized": self.template.plan_optimized}[plan_name]
        self.fuse_spmm_ema = bool(fuse_spmm_ema)
        # per-node fusion decisions (idx -> "admitted" | rejection reason);
        # empty when fusion was not requested
        self.fusion_report: dict[int, str] = {}
        fused_nodes = self._fused_candidates() if self.fuse_spmm_ema else ()

        # budget -> (batch size, liveness schedule); the memory model reads
        # only the itemsize, so it gets a numpy float of the same width
        self.exec_choice = pexec.pick_execution(
            self.plan, self.k, g.n, memory_budget_bytes=memory_budget_bytes,
            dtype=np.dtype(f"f{dtype.itemsize}"), fused=fused_nodes)
        self.schedule = self.exec_choice.schedule
        if not self.exec_choice.fits:
            raise NotImplementedError(
                f"one coloring's modeled peak of "
                f"{self.exec_choice.peak_bytes_per_coloring} bytes exceeds "
                f"the memory budget; the JAX package then runs colorset "
                f"chunking, which is {_TODO}; raise memory_budget_bytes")
        self.batch_size = int(batch_size if batch_size is not None
                              else self.exec_choice.batch_size)
        self._materialize()

    def _fused_candidates(self) -> tuple[int, ...]:
        """Plan nodes that run the fused SpMM->eMA kernel.

        A node is admitted when it is the sole consumer of its passive child
        and the child's ``C(k, t_p)`` rows fit one CUDA block's shared
        memory (:func:`~repro_torch.kernels.fused.ops.fused_fits_smem`).
        Consumers that share a passive child stay on the y-cache (one SpMM,
        then an eMA each): the shared-passive group kernel is not ported
        yet. Every decision lands in :attr:`fusion_report` and the
        ``fusion_admissions_total`` counters.
        """
        consumers: dict[int, list[int]] = {}
        for idx, node in enumerate(self.plan.nodes):
            if not node.is_leaf:
                consumers.setdefault(node.passive, []).append(idx)
        out: list[int] = []
        for idx, node in enumerate(self.plan.nodes):
            if node.is_leaf:
                continue
            c_p = comb(self.k, self.plan.nodes[node.passive].size)
            if len(consumers[node.passive]) > 1:
                self.fusion_report[idx] = "multi_consumer"
            elif fused_ops.fused_fits_smem(c_p, self.dtype):
                self.fusion_report[idx] = "admitted"
                out.append(idx)
            else:
                self.fusion_report[idx] = "smem_overflow"
        for verdict in self.fusion_report.values():
            if verdict == "admitted":
                _metrics.counter("fusion_admissions_total",
                                 outcome="admitted").inc()
            else:
                _metrics.counter("fusion_admissions_total",
                                 outcome="rejected", reason=verdict).inc()
        return tuple(out)

    # -------------------------------------------------------- device state
    def _materialize(self) -> None:
        """Build the device operands (see :meth:`release`)."""
        with _tracing.span("engine.materialize", engine=self.engine,
                           k=self.k):
            self._materialize_inner()

    def _materialize_inner(self) -> None:
        self._bsr = spmm_ops.prepare(self.g, dtype=self.dtype,
                                     device=self.device)
        # static split tables per internal plan node
        self._splits: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        for idx, node in enumerate(self.plan.nodes):
            if node.is_leaf:
                continue
            ia, ip = cs.split_tables(self.k, node.size,
                                     self.plan.nodes[node.active].size)
            self._splits[idx] = (
                torch.as_tensor(ia, dtype=torch.int32, device=self.device),
                torch.as_tensor(ip, dtype=torch.int32, device=self.device))
        self._released = False
        # peak live table bytes seen by the executor's on_step probe
        self._peak_bytes = 0

    def _peak_probe(self, step: int, live_bytes: int) -> None:
        """Executor ``on_step`` hook: the measured peak live table bytes,
        checked against the memory model's prediction."""
        if live_bytes > self._peak_bytes:
            self._peak_bytes = live_bytes

    @property
    def measured_peak_bytes(self) -> int:
        """Peak live table bytes of the walks run so far (0 before any);
        compare with :attr:`peak_table_bytes`, the model."""
        return self._peak_bytes

    @property
    def peak_table_bytes(self) -> int:
        """Modeled peak live table bytes of one batched dispatch."""
        return self.exec_choice.peak_bytes_per_coloring * self.batch_size

    def release(self) -> None:
        """Drop the device operands; the next count call rebuilds them."""
        self._bsr = None
        self._splits = {}
        self._released = True

    def _ensure(self) -> None:
        if self._released:
            self._materialize()

    # ------------------------------------------------------------------ api
    def count_colorful(self, colors) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (sum over the root table, root table) for one ``(n,)``
        coloring."""
        totals, roots = self.count_colorful_batch(
            torch.as_tensor(colors).reshape(1, -1))
        return totals[0], roots[0]

    def count_colorful_batch(self, colorings, batch_size: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched :meth:`count_colorful` over ``(B, n)`` colorings.

        -> (totals (B,), root tables (B, 1, n)), in the accumulator dtype
        and the storage dtype. Chunks of ``batch_size`` colorings (default:
        the budget-derived batch) run one plan walk each; a ragged tail
        runs at its own size (eager PyTorch has no compiled shape to keep).
        """
        self._ensure()
        colorings = torch.as_tensor(colorings).to(self.device)
        if colorings.dim() != 2:
            raise ValueError(f"expected (B, n) colorings, got "
                             f"{tuple(colorings.shape)}")
        b = colorings.shape[0]
        bs = min(batch_size or self.batch_size or b, b) or 1
        totals, roots = [], []
        for base in range(0, b, bs):
            tot, root = self._run(colorings[base: base + bs])
            totals.append(tot)
            roots.append(root)
        if not totals:
            return (torch.zeros(0, dtype=accum_dtype(self.dtype),
                                device=self.device),
                    torch.zeros((0, 1, self.g.n), dtype=self.dtype,
                                device=self.device))
        return torch.cat(totals), torch.cat(roots)

    def count_iterations_batch(self, iterations, seed: int = 0,
                               batch_size: int | None = None) -> dict:
        """``{iteration id: colorful sum}`` for explicit iteration ids.

        The colorings are drawn on the engine's device from
        ``fold_in(PRNGKey(seed), id)`` — the JAX package's stream, bit for
        bit — and each chunk of ``batch_size`` ids is one plan walk.
        """
        self._ensure()
        its = [int(i) for i in iterations]
        if not its:
            return {}
        bs = min(batch_size or self.batch_size or len(its), len(its))
        out: dict = {}
        for base in range(0, len(its), bs):
            chunk = its[base: base + bs]
            colorings = batch_colorings(seed, chunk, self.g.n, self.k,
                                        device=self.device)
            totals, _ = self._run(colorings)
            for it, v in zip(chunk, totals.tolist()):
                out[it] = float(v)
        return out

    def estimate(self, n_iters: int, seed: int = 0,
                 start_iteration: int = 0,
                 batch_size: int | None = None) -> dict:
        """Color-coding estimate averaged over ``n_iters`` colorings."""
        p = cs.colorful_probability(self.k)
        ids = range(start_iteration, start_iteration + n_iters)
        per = self.count_iterations_batch(ids, seed=seed,
                                          batch_size=batch_size)
        alpha = self.template.automorphisms
        samples = [per[it] / (alpha * p) for it in ids]
        arr = np.asarray(samples)
        return {
            "count": float(arr.mean()),
            "std": float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
            "samples": samples,
            "n_iters": n_iters,
            "alpha": alpha,
            "colorful_probability": p,
        }

    # ------------------------------------------------------------- the walk
    def _leaf_table_cn(self, colors: torch.Tensor) -> torch.Tensor:
        """(..., k, N) one-hot of vertex colors — combination-major
        leaves; a leading batch dimension broadcasts through."""
        ks = torch.arange(self.k, dtype=colors.dtype, device=colors.device)
        return (ks[:, None] == colors[..., None, :]).to(self.dtype)

    def _run(self, colorings: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """One plan walk for a ``(B, n)`` chunk -> (totals, root tables)."""
        with _tracing.span("engine.dispatch", engine=self.engine,
                           batch=int(colorings.shape[0])):
            totals, root = self._build_pgbsc()(colorings)
            _tracing.sync_ready(totals)
        return totals, root

    def _build_pgbsc(self):
        splits, prep = self._splits, self._bsr
        runner = pexec.PlanExecutor(self.plan, self.schedule)

        def passive_op(p_idx, m_p):
            # SpMM over *all* passive color sets at once (Algorithm 4 l.3);
            # the executor's y-cache shares it between consumers
            return spmm_ops.spmm(m_p, prep)

        def combine(idx, m_a, y_p):
            ia, ip = splits[idx]
            return ema_ops.ema(m_a, y_p, ia, ip)

        def combine_direct(idx, m_a, m_p):
            # fused node: SpMM and eMA in one launch; the neighbor sums
            # live only in shared memory
            ia, ip = splits[idx]
            return fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, prep)

        # sub-f32 storage sums its root table in the accumulator dtype
        acc_dt = accum_dtype(self.dtype)

        def run(colors: torch.Tensor):
            leaf = self._leaf_table_cn(colors)
            root = runner.run(leaf, passive_op=passive_op, combine=combine,
                              combine_direct=combine_direct,
                              on_step=self._peak_probe)
            return root.to(acc_dt).sum(dim=(-2, -1)), root

        return run

