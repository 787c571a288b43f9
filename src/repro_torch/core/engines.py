"""The three counting engines on PyTorch: FASCIA, PFASCIA, PGBSC (paper
§3-4).

All three compute the number of colorful rooted embeddings of each
sub-template, bottom-up over the execution plan, in the paper's three
regimes:

* ``fascia``   Algorithm 1: row-major ``(B, N, C)`` tables and a padded
               neighbor (ELL) sweep recomputed for every (color set,
               split) pair — O(E * C(k,t) * C(t,t_p)) per sub-template.
* ``pfascia``  + pruning (§4.1-4.2): one sweep per distinct passive child,
               hoisted out of the split loop. Still row-major.
* ``pgbsc``    + GraphBLAS (§4.3-4.5), below.

The row-major engines run torch's own ops on either device (the
reference's are XLA scans, no Pallas kernel): the sweep adds the neighbor
table's columns in order, accumulating in the accumulator dtype, and the
combine adds the splits in order. FASCIA's per-split sweep is the paper's
§3.1 redundancy, kept on purpose: the baseline's cost is the point.

PGBSC: combination-major ``(B, C, N)`` count tables, one SpMM ``Y = M_p @ A``
per distinct passive child (over the BSR nonzero index or, with
``spmm_method="gather"``, the edge stream) and an eMA per plan node — or
both in one fused kernel launch where the passive child has a single
consumer, or one shared-passive group launch where several template roots
share it, and the card's shared-memory fit model admits it. The walk is
the shared :class:`~repro_torch.core.executor.PlanExecutor`; the kernels
are ``kernels/{spmm,ema,fused}``, which launch CUDA on the card and run
their plain PyTorch versions on the CPU. When one coloring's tables do not
fit the memory budget, the executor's model chunks the passive colour sets
of the nodes at the peak, and those nodes run the chunked eMA (one SpMM and
one chunk-accumulate launch a chunk). ``reorder="rcm" | "degree"`` walks
the plan on a relabelled graph, with colorings and root tables mapped at
the engine's boundary.

A port of the JAX package's ``core/engines.py``, one template or a fused
bundle of same-k templates on each engine. An explicit batch dimension
takes the place of the reference's ``jax.vmap``. Each coloring's total
is summed in float64 from its own root table, exactly for these integer
counts, so it is bitwise independent of the batch it ran in (the
runner's resume-equals-straight invariant).
"""

from __future__ import annotations

import dataclasses
import time
from math import comb

import numpy as np
import torch

from repro_torch.core import colorsets as cs
from repro_torch.core import executor as pexec
from repro_torch.core.templates import (ExecutionPlan, as_template,
                                        compile_fused_plan)
from repro_torch.device import CARD_DTYPES, accum_dtype, resolve_device
from repro_torch.graph.coloring import batch_colorings
from repro_torch.graph.reorder import ORDERINGS, apply_order, inverse_order
from repro_torch.graph.structure import Graph
from repro_torch.kernels.ema import ops as ema_ops
from repro_torch.kernels.fused import ops as fused_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing

__all__ = ["CountingEngine", "WorkEstimate", "build_engine", "ENGINES"]

ENGINES = ("fascia", "pfascia", "pgbsc")


@dataclasses.dataclass
class WorkEstimate:
    """Static op counts for ONE coloring (the reference's).

    All per-coloring fields share units, so flops/bytes ratios are valid
    arithmetic intensities. ``table_bytes`` is dtype-aware (C(k,t) x N x
    itemsize summed over internal plan nodes); ``batch`` records the
    engine's dispatch batch size, and the ``dispatch_*`` properties give
    the per-dispatch totals.
    """

    spmm_flops: int = 0
    ema_flops: int = 0
    table_bytes: int = 0
    batch: int = 1

    @property
    def total_flops(self) -> int:
        return self.spmm_flops + self.ema_flops

    @property
    def dispatch_flops(self) -> int:
        return self.total_flops * self.batch

    @property
    def dispatch_table_bytes(self) -> int:
        return self.table_bytes * self.batch


class CountingEngine:
    """Counts colorful embeddings of one template — or a fused bundle of
    same-k templates — for given colorings, on one of :data:`ENGINES`.

    :meth:`count_colorful` takes an ``(n,)`` coloring and returns the sum
    over the root table (= alpha x #colorful copies) and the root table;
    :meth:`count_colorful_batch` takes ``(B, n)``; :meth:`estimate` runs
    the color-coding estimator over colorings drawn on the engine's device
    from the same stream as the JAX package (``graph/coloring.py``).

    A list or tuple of equal-k templates builds ONE fused plan
    (:func:`~repro_torch.core.templates.compile_fused_plan`): canonical
    rooted sub-templates shared across the bundle are computed once per
    coloring, every template's root table is a kept output of the walk, and
    totals come back as ``(T,)`` per coloring (``(B, T)`` batched) with a
    T-tuple of root tables; :meth:`estimate_many` gives one estimate per
    template. ``n_colorings_dispatched`` counts the colorings walked and
    ``n_spmm_cols_dispatched`` the SpMM column-ops they cost, so the
    savings are observable.

    ``memory_budget_bytes`` becomes the coloring batch size through the
    executor's memory model (fused nodes are charged no neighbor-sum
    table; FASCIA caches no passive transform); when even one coloring
    exceeds it, the PGBSC model chunks passive colour sets (:attr:`schedule`
    ``.chunk_map``), and where even single-row chunks do not fit — or on
    the row-major engines, which do not chunk — it runs its best effort at
    batch 1 with ``exec_choice.fits`` False, as the JAX package does. The
    row-major engines' sweep and split temporaries (a few ``(B, N, S)``
    buffers at the widest node) lie outside the model, as in the
    reference. ``batch_size`` overrides the derived batch. ``reorder``
    ("rcm" or "degree") permutes the graph once here; callers pass
    colorings and read root tables in their own vertex ids.
    ``autotune_blocks=True`` lets the autotuner pick the launch shapes of
    the passive SpMM, the eMA and the chunked walk's row-chunk SpMM, once
    per shape (``kernels/autotune.py``), as the reference's
    ``_build_pgbsc`` does; the fused, group and chunk-accumulate kernels
    keep theirs.
    ``device=None`` runs on CUDA and raises without a card;
    ``device="cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, g: Graph, template, engine: str = "pgbsc",
                 spmm_method: str = "bsr", plan: str | None = None,
                 dtype=torch.float32, batch_size: int | None = None,
                 memory_budget_bytes: int | None = None,
                 fuse_spmm_ema: bool = True,
                 autotune_blocks: bool = False, reorder: str | None = None,
                 device=None):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; choose from "
                             f"{ENGINES}")
        if spmm_method not in spmm_ops.METHODS:
            raise ValueError(f"unknown SpMM backend {spmm_method!r}; "
                             f"choose from {spmm_ops.METHODS}")
        if reorder not in (None, "", *ORDERINGS):
            raise ValueError(f"unknown reorder {reorder!r}; "
                             f"choose from {sorted(ORDERINGS)} or None")
        if isinstance(template, (list, tuple)):
            if not template:
                raise ValueError("engine needs at least one template")
            templates = tuple(as_template(t) for t in template)
        else:
            templates = (as_template(template),)
        ks = sorted({t.k for t in templates})
        if len(ks) != 1:
            raise ValueError(
                f"one engine fuses equal-k templates only, got k={ks}; "
                "group by k first (repro_torch.api.count_many does)")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype not in CARD_DTYPES:
            raise TypeError(f"the card runs {sorted(map(str, CARD_DTYPES))} "
                            f"tables, got {dtype}")
        # Vertex reordering: permute the graph ONCE here; the plan walk
        # runs in the permuted vertex space and only the engine boundary
        # permutes (colorings in, root tables out: _run). The occupied
        # blocks before and after are published as gauges.
        self.reorder = reorder or None
        self._order = None
        # host seconds of the ordering and the relabelling (set-up time)
        self.reorder_seconds: dict[str, float] = {}
        if self.reorder:
            before = g.bsr_block_stats()
            t0 = time.perf_counter()
            self._order = ORDERINGS[self.reorder](g)
            t1 = time.perf_counter()
            g = apply_order(g, self._order)
            self.reorder_seconds = {"order": t1 - t0,
                                    "apply": time.perf_counter() - t1}
            after = g.bsr_block_stats()
            for stage, stats in (("before", before), ("after", after)):
                _metrics.gauge("reorder_bsr_occupied_blocks",
                               reorder=self.reorder, stage=stage
                               ).set(stats["occupied_blocks"])
                _metrics.gauge("reorder_bsr_block_density",
                               reorder=self.reorder, stage=stage
                               ).set(stats["block_density"])
        self.g = g
        self.templates = templates
        self.template = templates[0]
        self.fused = len(templates) > 1
        self.engine = engine
        self.spmm_method = spmm_method
        self.k = ks[0]
        self.dtype = dtype
        self.memory_budget_bytes = memory_budget_bytes
        plan_name = plan or "plain"
        if self.fused:
            if plan_name == "plain":
                raise ValueError(
                    "plan='plain' is meaningless for a fused multi-template "
                    "engine: cross-template fusion IS canonical dedup; use "
                    "plan='dedup' or plan='optimized'")
            fp = compile_fused_plan(templates,
                                    optimize=(plan_name == "optimized"))
            self.plan: ExecutionPlan = fp.plan
            self.roots: tuple[int, ...] = fp.roots
        else:
            self.plan = {
                "plain": self.template.plan, "dedup": self.template.plan_dedup,
                "optimized": self.template.plan_optimized}[plan_name]
            self.roots = (self.plan.n_nodes - 1,)
        self.fuse_spmm_ema = bool(fuse_spmm_ema and engine == "pgbsc")
        self.autotune_blocks = bool(autotune_blocks)
        # per-node fusion decisions (idx -> "admitted" | "admitted_shared" |
        # rejection reason); empty when fusion was not requested
        self.fusion_report: dict[int, str] = {}
        fused_nodes, fused_groups = (self._fused_candidates()
                                     if self.fuse_spmm_ema else ((), ()))

        # budget -> (batch size, liveness schedule, chunking); the memory
        # model reads only the itemsize, so it gets a numpy float of the
        # same width. An explicit batch_size overrides only the batch.
        # Every fused root is a kept output (never freed by the walk).
        keep = tuple(i for i in self.roots if i != self.plan.n_nodes - 1)
        self.exec_choice = pexec.pick_execution(
            self.plan, self.k, g.n, memory_budget_bytes=memory_budget_bytes,
            dtype=np.dtype(f"f{dtype.itemsize}"),
            passive_cache=(engine != "fascia"),
            allow_chunking=(engine == "pgbsc"), keep=keep,
            fused=fused_nodes, fused_groups=fused_groups)
        self.schedule = self.exec_choice.schedule
        self.batch_size = int(batch_size if batch_size is not None
                              else self.exec_choice.batch_size)
        self._materialize()
        self.work = self._estimate_work()
        self.spmm_cols_per_coloring = self._spmm_cols_per_coloring()
        # colorings walked, and the SpMM column-ops they cost (the
        # fused-plan savings metric)
        self.n_colorings_dispatched = 0
        self.n_spmm_cols_dispatched = 0

    def _fused_candidates(self) -> tuple[tuple[int, ...],
                                         tuple[tuple[int, ...], ...]]:
        """Plan nodes that run a fused SpMM->eMA kernel, and the
        shared-passive groups among them — returns ``(fused, groups)``.

        A sole consumer of its passive child fuses alone when the child's
        ``C(k, t_p)`` rows fit one CUDA block's shared memory
        (:func:`~repro_torch.kernels.fused.ops.fused_fits_smem`).

        Consumers SHARING a passive child fuse as a group: one launch of
        the group kernel whose SpMM leg runs once into shared memory (the
        y-cache's dedup win without the device-memory round trip). A group
        is admitted only when it covers the passive's ENTIRE consumer set
        (a partial group would re-run the SpMM for the leftovers), when no
        member's active child is itself a member (the launch cannot consume
        its own outputs), when the card's group fit model admits it
        (:func:`~repro_torch.kernels.fused.ops.fused_group_fits_smem`), and
        when the members can be made consecutive in program order (no
        outside consumer of a member sits at or before the latest member).
        Chain-shaped consumer sets fail the intra-dependency test by
        construction and stay on the y-cache; the win case is template
        ROOTS sharing a canonical passive sub-template.

        Every decision lands in :attr:`fusion_report` and the
        ``fusion_admissions_total`` counters.
        """
        consumers: dict[int, list[int]] = {}
        cons_any: dict[int, list[int]] = {}
        for idx, node in enumerate(self.plan.nodes):
            if node.is_leaf:
                continue
            consumers.setdefault(node.passive, []).append(idx)
            cons_any.setdefault(node.active, []).append(idx)
            cons_any.setdefault(node.passive, []).append(idx)

        def c_p(idx: int) -> int:
            return comb(self.k, self.plan.nodes[self.plan.nodes[idx].passive]
                        .size)

        def order_ok(members: list[int]) -> bool:
            # regrouping moves members to the LAST member's slot; any
            # outside consumer of a member scheduled at or before that slot
            # would then precede its producer
            anchor = max(members)
            mset = set(members)
            return all(c > anchor or c in mset
                       for m in members for c in cons_any.get(m, []))

        out: list[int] = []
        groups: list[tuple[int, ...]] = []
        for idx, node in enumerate(self.plan.nodes):
            if node.is_leaf:
                continue
            if len(consumers[node.passive]) > 1:
                # members of an accepted group are upgraded below
                self.fusion_report[idx] = "multi_consumer"
            elif fused_ops.fused_fits_smem(c_p(idx), self.dtype):
                self.fusion_report[idx] = "admitted"
                out.append(idx)
            else:
                self.fusion_report[idx] = "smem_overflow"
        for p, cons in sorted(consumers.items()):
            if len(cons) < 2:
                continue
            mset = set(cons)
            if (not any(self.plan.nodes[m].active in mset for m in cons)
                    and fused_ops.fused_group_fits_smem(len(cons),
                                                        c_p(cons[0]),
                                                        self.dtype)
                    and order_ok(cons)):
                grp = tuple(sorted(cons))
                groups.append(grp)
                for m in grp:
                    self.fusion_report[m] = "admitted_shared"
                    out.append(m)
        for verdict in self.fusion_report.values():
            if verdict == "admitted":
                _metrics.counter("fusion_admissions_total",
                                 outcome="admitted").inc()
            elif verdict == "admitted_shared":
                _metrics.counter("fusion_admissions_total",
                                 outcome="admitted", mode="shared").inc()
            else:
                _metrics.counter("fusion_admissions_total",
                                 outcome="rejected", reason=verdict).inc()
        return tuple(sorted(out)), tuple(groups)

    # -------------------------------------------------------- device state
    def _materialize(self) -> None:
        """Build the device operands (see :meth:`release`)."""
        with _tracing.span("engine.materialize", engine=self.engine,
                           k=self.k):
            self._materialize_inner()

    def _materialize_inner(self) -> None:
        if self._order is not None:
            # the boundary permutation on the device: order takes a
            # coloring in, its inverse takes a root table out
            self._order_dev = torch.as_tensor(self._order,
                                              device=self.device)
            self._inv_dev = torch.as_tensor(inverse_order(self._order),
                                            device=self.device)
        else:
            self._order_dev = self._inv_dev = None
        self._splits: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._chunk_walks: dict[int, ema_ops.ChunkWalk] = {}
        self._released = False
        # peak live table bytes seen by the executor's on_step probe
        self._peak_bytes = 0
        if self.engine != "pgbsc":
            # the row-major engines: the padded neighbor table by column,
            # (max_deg, N), its mask broadcastable over (B, N, S) tables,
            # and each node's split columns as (L, S) index rows
            nbr, mask = self.g.ell()
            self._spmm_prep = self._fused_prep = None
            self._nbr = torch.as_tensor(nbr.T, dtype=torch.int64
                                        ).contiguous().to(self.device)
            self._mask = torch.as_tensor(mask.T[:, :, None]).to(
                device=self.device, dtype=accum_dtype(self.dtype))
            for idx, node in enumerate(self.plan.nodes):
                if not node.is_leaf:
                    ia, ip = cs.split_tables(
                        self.k, node.size, self.plan.nodes[node.active].size)
                    self._splits[idx] = tuple(
                        torch.as_tensor(t.T, dtype=torch.int64)
                        .contiguous().to(self.device) for t in (ia, ip))
            return
        self._nbr = self._mask = None
        self._spmm_prep = spmm_ops.prepare(self.g, self.spmm_method,
                                           dtype=self.dtype,
                                           device=self.device,
                                           reorder=self.reorder or "")
        # fused nodes walk the BSR index whatever the SpMM operand is; a
        # node both fused and chunked runs chunked
        chunk_map = self.schedule.chunk_map
        if not set(self.schedule.fused) - set(chunk_map):
            self._fused_prep = None
        elif self.spmm_method == "bsr":
            self._fused_prep = self._spmm_prep
        else:
            self._fused_prep = spmm_ops.prepare(self.g, "bsr",
                                                dtype=self.dtype,
                                                device=self.device,
                                                reorder=self.reorder or "")
        # static split tables per internal plan node, and the chunked pair
        # walk of each node the memory model chunked
        for idx, node in enumerate(self.plan.nodes):
            if node.is_leaf:
                continue
            t_a = self.plan.nodes[node.active].size
            ia, ip = cs.split_tables(self.k, node.size, t_a)
            self._splits[idx] = (
                torch.as_tensor(ia, dtype=torch.int32, device=self.device),
                torch.as_tensor(ip, dtype=torch.int32, device=self.device))
            q = chunk_map.get(idx, 1)
            if q > 1:
                pack = ema_ops.pack_chunked_splits(
                    ia, ip, comb(self.k, node.size - t_a), q)
                self._chunk_walks[idx] = ema_ops.chunk_walk(pack,
                                                            self.device)

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
        """Drop the device operands; the next count call rebuilds them.

        Their memory goes back to torch's caching allocator, where the next
        tensor of the process reuses it, not to the card
        (``torch.cuda.empty_cache()`` returns the allocator's free blocks).
        Nothing a count call allocates outlives it: the operands and split
        tables built here are only read, and every table, scratch and total
        of a walk is the call's own.
        """
        self._spmm_prep = self._fused_prep = None
        self._nbr = self._mask = None
        self._order_dev = self._inv_dev = None
        self._splits = {}
        self._chunk_walks = {}
        self._released = True

    def _ensure(self) -> None:
        if self._released:
            self._materialize()

    # ------------------------------------------------------------------ api
    def count_colorful(self, colors):
        """-> (sum over the root table, root table) for one ``(n,)``
        coloring; a fused engine returns a ``(T,)`` sum and a T-tuple of
        root tables."""
        totals, roots = self.count_colorful_batch(
            torch.as_tensor(colors).reshape(1, -1))
        if self.fused:
            return totals[0], tuple(r[0] for r in roots)
        return totals[0], roots[0]

    def count_colorful_batch(self, colorings, batch_size: int | None = None):
        """Batched :meth:`count_colorful` over ``(B, n)`` colorings.

        -> (totals (B,), root tables (B, 1, n) — (B, n, 1) on the row-major
        engines), in the accumulator dtype and the storage dtype; a fused
        engine returns totals ``(B, T)`` and a T-tuple of root-table
        batches. Chunks of ``batch_size`` colorings
        (default: the budget-derived batch) run one plan walk each; a
        ragged tail runs at its own size (eager PyTorch has no compiled
        shape to keep).
        """
        self._ensure()
        colorings = torch.as_tensor(colorings).to(self.device)
        if colorings.dim() != 2:
            raise ValueError(f"expected (B, n) colorings, got "
                             f"{tuple(colorings.shape)}")
        b = colorings.shape[0]
        if b == 0:
            acc = accum_dtype(self.dtype)
            if self.fused:
                return (torch.zeros((0, len(self.templates)), dtype=acc,
                                    device=self.device), ())
            shape = ((0, 1, self.g.n) if self.engine == "pgbsc"
                     else (0, self.g.n, 1))
            return (torch.zeros(0, dtype=acc, device=self.device),
                    torch.zeros(shape, dtype=self.dtype, device=self.device))
        bs = min(batch_size or self.batch_size or b, b) or 1
        totals, roots = [], []
        for base in range(0, b, bs):
            tot, root = self._run(colorings[base: base + bs])
            totals.append(tot)
            roots.append(root)
        if self.fused:
            return torch.cat(totals), tuple(
                torch.cat([r[j] for r in roots])
                for j in range(len(self.roots)))
        return torch.cat(totals), torch.cat(roots)

    def count_iterations_batch(self, iterations, seed: int = 0,
                               batch_size: int | None = None) -> dict:
        """``{iteration id: colorful sum}`` for explicit iteration ids — a
        float per id, or a ``(T,)`` float64 array per id for a fused engine
        (template order = ``self.templates``).

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
            vals = totals.double().cpu().numpy()
            for i, it in enumerate(chunk):
                out[it] = vals[i].copy() if self.fused else float(vals[i])
        return out

    def estimate(self, n_iters: int, seed: int = 0,
                 start_iteration: int = 0,
                 batch_size: int | None = None) -> dict:
        """Color-coding estimate averaged over ``n_iters`` colorings."""
        if self.fused:
            raise ValueError("estimate() is single-template; fused engines "
                             "use estimate_many()")
        return self.estimate_many(n_iters, seed=seed,
                                  start_iteration=start_iteration,
                                  batch_size=batch_size)[0]

    def estimate_many(self, n_iters: int, seed: int = 0,
                      start_iteration: int = 0,
                      batch_size: int | None = None) -> list[dict]:
        """Per-template color-coding estimates from ONE fused plan run, one
        :meth:`estimate`-shaped dict per template (``self.templates``
        order); every template's samples come from the same colorings."""
        p = cs.colorful_probability(self.k)
        ids = range(start_iteration, start_iteration + n_iters)
        per = self.count_iterations_batch(ids, seed=seed,
                                          batch_size=batch_size)
        vals = np.stack([np.atleast_1d(np.asarray(per[it])) for it in ids])
        results = []
        for j, t in enumerate(self.templates):
            alpha = t.automorphisms
            samples = [float(v) / (alpha * p) for v in vals[:, j]]
            arr = np.asarray(samples)
            results.append({
                "count": float(arr.mean()),
                "std": float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
                "samples": samples,
                "n_iters": n_iters,
                "alpha": alpha,
                "colorful_probability": p,
            })
        return results

    # ------------------------------------------------------------- the walk
    def _leaf_table_cn(self, colors: torch.Tensor) -> torch.Tensor:
        """(..., k, N) one-hot of vertex colors — combination-major
        leaves; a leading batch dimension broadcasts through."""
        ks = torch.arange(self.k, dtype=colors.dtype, device=colors.device)
        return (ks[:, None] == colors[..., None, :]).to(self.dtype)

    def _leaf_table_nc(self, colors: torch.Tensor) -> torch.Tensor:
        """(..., N, k) one-hot of vertex colors — row-major leaves."""
        ks = torch.arange(self.k, dtype=colors.dtype, device=colors.device)
        return (colors[..., :, None] == ks).to(self.dtype)

    def _totals(self, root: torch.Tensor) -> torch.Tensor:
        """Per-coloring sums of a ``(..., R, C)`` root table in the
        accumulator dtype. The sum runs in float64, exact for these integer
        counts below 2^53, so a coloring's total does not depend on the
        order the device sums it in, which may change with the batch."""
        return root.to(torch.float64).sum(dim=(-2, -1)).to(
            accum_dtype(self.dtype))

    def _run(self, colorings: torch.Tensor):
        """One plan walk for a ``(B, n)`` chunk -> (totals, root tables)."""
        b = int(colorings.shape[0])
        with _tracing.span("engine.dispatch", engine=self.engine, batch=b):
            if self._order_dev is not None:
                # into the engine's vertex space, and the roots back out;
                # totals are sums over whole tables and need nothing
                colorings = colorings.index_select(-1, self._order_dev)
            if self.engine == "pgbsc":
                totals, root = self._build_pgbsc()(colorings)
            else:
                totals, root = self._build_rowmajor(
                    pruned=self.engine == "pfascia")(colorings)
            if self._inv_dev is not None:
                # combination-major roots keep vertices last, row-major
                # roots second to last
                inv = self._inv_dev
                vaxis = -1 if self.engine == "pgbsc" else -2
                root = (tuple(r.index_select(vaxis, inv) for r in root)
                        if self.fused else root.index_select(vaxis, inv))
            _tracing.sync_ready(totals)
        self.n_colorings_dispatched += b
        self.n_spmm_cols_dispatched += self.spmm_cols_per_coloring * b
        return totals, root

    def _build_pgbsc(self):
        splits, prep, fprep = self._splits, self._spmm_prep, self._fused_prep
        walks = self._chunk_walks
        runner = pexec.PlanExecutor(self.plan, self.schedule)
        autotune = self.autotune_blocks

        def passive_op(p_idx, m_p):
            # SpMM over *all* passive color sets at once (Algorithm 4 l.3);
            # the executor's y-cache shares it between consumers
            return spmm_ops.spmm(m_p, prep, autotune=autotune)

        def combine(idx, m_a, y_p):
            ia, ip = splits[idx]
            return ema_ops.ema(m_a, y_p, ia, ip, autotune=autotune)

        def combine_direct(idx, m_a, m_p):
            # chunking wins over fusion when the memory model assigned both
            if idx in walks:
                # colorset-chunked node: the passive SpMM output is made
                # and consumed one slice of C(k, t_p) rows at a time
                return ema_ops.ema_chunked(
                    m_a, m_p, walks[idx],
                    lambda m: spmm_ops.spmm(m, prep, autotune=autotune))
            # fused node: SpMM and eMA in one launch; the neighbor sums
            # live only in shared memory
            ia, ip = splits[idx]
            return fused_ops.fused_spmm_ema(m_a, m_p, ia, ip, fprep)

        def combine_group(members, m_as, m_p):
            # shared-passive group: ONE launch computes the passive child's
            # neighbor sums once in shared memory and applies every
            # member's split combination against them
            return fused_ops.fused_spmm_ema_shared(
                m_as, m_p, [splits[m][0] for m in members],
                [splits[m][1] for m in members], fprep)

        def run(colors: torch.Tensor):
            leaf = self._leaf_table_cn(colors)
            outs = runner.run(leaf, passive_op=passive_op, combine=combine,
                              combine_direct=combine_direct,
                              combine_group=combine_group,
                              on_step=self._peak_probe, outputs=self.roots)
            return self._root_totals(outs)

        return run

    def _root_totals(self, outs):
        """(totals, root) of one walk's outputs; a fused walk gives one
        (..., T) totals vector, template j's entry from its own root."""
        if not self.fused:
            return self._totals(outs[0]), outs[0]
        return torch.stack([self._totals(r) for r in outs], dim=-1), outs

    def _build_rowmajor(self, pruned: bool):
        """FASCIA / PFASCIA: row-major (B, N, C) tables + the ELL sweep.

        Every step keeps the reference's order: the sweep adds neighbor
        columns d = 0, 1, ... and the combine splits l = 0, 1, ... into an
        accumulator of the accumulator dtype, cast down once. Gathers go
        into buffers reused across columns and splits, so a step holds a
        few ``(B, N, S)`` temporaries whatever its split count."""
        splits, nbr, mask = self._splits, self._nbr, self._mask
        runner = pexec.PlanExecutor(self.plan, self.schedule)
        acc_dt = accum_dtype(self.dtype)

        def nbr_sum(m_cols, acc=None, buf=None):
            # out[b, i, r] = sum_d m_cols[b, nbr[d, i], r] * mask[d, i]
            return spmm_ops.ell_sweep(m_cols, nbr, mask, -2, acc,
                                      buf).to(m_cols.dtype)

        def passive_op(p_idx, m_p):
            # PFASCIA: one neighbor sweep per distinct passive set
            return nbr_sum(m_p)

        def combine(idx, m_a, y_p):
            ia, ip = splits[idx]
            shape = m_a.shape[:-1] + (ia.shape[1],)
            acc = torch.zeros(shape, dtype=acc_dt, device=m_a.device)
            g_a = torch.empty(shape, dtype=m_a.dtype, device=m_a.device)
            g_p = torch.empty(shape, dtype=y_p.dtype, device=y_p.device)
            for l in range(ia.shape[0]):
                torch.index_select(m_a, -1, ia[l], out=g_a)
                torch.index_select(y_p, -1, ip[l], out=g_p)
                acc.addcmul_(g_a, g_p)
            return acc.to(self.dtype)

        def combine_direct(idx, m_a, m_p):
            # FASCIA: the neighbor sweep is *inside* the split loop — the
            # redundancy of paper §3.1, preserved deliberately
            ia, ip = splits[idx]
            shape = m_a.shape[:-1] + (ia.shape[1],)
            out = torch.zeros(shape, dtype=acc_dt, device=m_a.device)
            cols = torch.empty(shape, dtype=m_p.dtype, device=m_p.device)
            sweep = torch.empty(shape, dtype=acc_dt, device=m_p.device)
            buf = torch.empty_like(cols)
            for l in range(ia.shape[0]):
                torch.index_select(m_p, -1, ip[l], out=cols)
                y_l = nbr_sum(cols, sweep, buf)       # (B, N, S) per split
                torch.index_select(m_a, -1, ia[l], out=cols)
                out.addcmul_(cols, y_l)
            return out.to(self.dtype)

        def run(colors: torch.Tensor):
            leaf = self._leaf_table_nc(colors)
            outs = runner.run(
                leaf, passive_op=passive_op if pruned else None,
                combine=combine, combine_direct=combine_direct,
                on_step=self._peak_probe, outputs=self.roots)
            return self._root_totals(outs)

        return run

    # ------------------------------------------------------------- analysis
    @property
    def flops_per_iteration(self) -> int:
        return self.work.total_flops

    def _spmm_cols_per_coloring(self) -> int:
        """Static SpMM (passive-transform) column count of one coloring.

        ``pgbsc``/``pfascia`` pay ``C(k, t_p)`` columns once per *distinct*
        passive child (the executor's y-cache), which is where fused plans
        win: a passive sub-template shared across templates is one SpMM for
        the whole bundle. A shared-passive fused GROUP keeps that
        once-per-child cost; singleton-fused and colorset-chunked nodes
        bypass the cache and pay per consumer; ``fascia`` recomputes the
        sweep inside the split loop (``C(k, t)`` columns per split, paper
        §3.1).
        """
        cols = 0
        seen: set[int] = set()
        counted_groups: set[tuple[int, ...]] = set()
        chunk_map = self.schedule.chunk_map
        fused_set = self.schedule.fused_set
        group_of = self.schedule.group_of
        for idx, node in enumerate(self.plan.nodes):
            if node.is_leaf:
                continue
            c_p = comb(self.k, self.plan.nodes[node.passive].size)
            if self.engine == "fascia":
                t_a = self.plan.nodes[node.active].size
                cols += comb(self.k, node.size) * comb(node.size, t_a)
            elif idx in group_of and chunk_map.get(idx, 1) <= 1:
                if group_of[idx] not in counted_groups:
                    counted_groups.add(group_of[idx])
                    cols += c_p
            elif chunk_map.get(idx, 1) > 1 or idx in fused_set:
                cols += c_p
            elif node.passive not in seen:
                seen.add(node.passive)
                cols += c_p
        return cols

    def _estimate_work(self) -> WorkEstimate:
        w = WorkEstimate(batch=max(1, self.batch_size))
        n, e, k = self.g.n, self.g.m, self.k
        itemsize = self.dtype.itemsize
        for node in self.plan.nodes:
            if node.is_leaf:
                continue
            t = node.size
            t_a = self.plan.nodes[node.active].size
            n_sets, n_splits = comb(k, t), comb(t, t_a)
            if self.engine == "fascia":
                w.spmm_flops += e * n_sets * n_splits
            else:
                w.spmm_flops += e * comb(k, t - t_a)
            w.ema_flops += 2 * n * n_sets * n_splits
            w.table_bytes += itemsize * n * n_sets
        return w


def build_engine(g: Graph, template, engine: str = "pgbsc",
                 **kw) -> CountingEngine:
    """Convenience constructor (see CountingEngine). ``template`` accepts a
    TreeTemplate / TemplateSpec / registry name, or a list of them (equal k)
    for a fused multi-template engine."""
    return CountingEngine(g, template, engine=engine, **kw)
