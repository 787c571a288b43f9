"""Memory-aware execution of an :class:`ExecutionPlan` (paper §4.3–4.5).

Tree subgraph counting is memory bounded: at k >= 12 the ``C(k,t) x N``
count tables dominate the footprint, so the executor treats memory as a
managed resource instead of keeping every plan-node table (and every cached
SpMM result) alive for the whole bottom-up walk. Three cooperating pieces:

* **Liveness** (:func:`liveness`): for a given evaluation order, the last
  use of every node table and every ``y_cache`` SpMM entry is computed
  statically; :class:`PlanExecutor` drops each buffer at its last use, so
  the walk holds only the live frontier of the DP, not the whole history.
* **Scheduling** (:func:`compute_schedule`): the post-order plan admits many
  valid bottom-up orders. A greedy list scheduler picks, among the nodes
  whose children are ready, the one minimizing the step's modeled peak
  (Sethi–Ullman's "heavier subtree first" generalized to the dedup DAG);
  the better of {greedy, program order} is kept.
* **Analytic memory model** (:func:`peak_table_bytes` /
  :func:`pick_execution`): simulates the scheduled walk in units of table
  rows and turns a single ``memory_budget_bytes`` knob into the coloring
  batch size. When even batch=1 exceeds the budget, per-node **colorset
  chunking** is enabled: the ``C(k, t_p)`` passive axis of the SpMM/eMA is
  split so the passive neighbor-sum table is never materialized whole
  (see ``kernels/ema/ops.ema_chunked``) — k >= 13 templates then run under
  budgets where the unchunked walk cannot run at all.

All three engines (fascia / pfascia / pgbsc) ride the same
:class:`PlanExecutor`; they differ only in the callbacks supplied
(neighbor sweep vs. SpMM passive transform, split loop vs. kernel eMA
combine, and no cached transform at all for FASCIA).

A copy of the JAX package's ``core/executor.py``: liveness, schedules and
the memory model are the reference's, byte for byte, for every engine.
One change: :meth:`PlanExecutor._live_bytes` sizes torch tensors.
"""

from __future__ import annotations

import dataclasses
from math import comb

import numpy as np

from repro_torch.obs import tracing as _tracing

__all__ = [
    "Schedule", "ExecutionChoice", "PlanExecutor",
    "liveness", "compute_schedule", "simulate_peak_rows",
    "peak_table_bytes", "keep_everything_bytes", "pick_execution",
    "DEFAULT_MEMORY_BUDGET_BYTES", "MAX_AUTO_BATCH", "PAIR_BLOCK",
]

# Default budget when the caller gives none: generous enough that small
# problems batch freely, finite so huge plans still get a managed schedule.
DEFAULT_MEMORY_BUDGET_BYTES = 1 << 30
# Ceiling on the budget-derived coloring batch (diminishing returns past
# this; keeps first-call latency bounded for tiny graphs).
MAX_AUTO_BATCH = 64
# Rows of the (PAIR_BLOCK, N) working term buffer the model charges a
# chunked eMA step (the reference's scatter-add block; the port's kernel
# needs no such buffer, so its steps come in under the charge).
PAIR_BLOCK = 128


# --------------------------------------------------------------------------
# schedule representation
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Schedule:
    """A validated evaluation order plus static liveness for one plan.

    ``order``
        Topological order over *all* node indices (leaves included); the
        root is necessarily last (every plan node is in the root's cone).
    ``free_tables[s]`` / ``free_y[s]``
        Node-table indices / y-cache keys that are dead after step ``s``
        (the step evaluating ``order[s]``) and are dropped there.
    ``chunks``
        ``(node idx, n_chunks)`` pairs for colorset-chunked internal nodes
        (absent = unchunked). Chunked nodes bypass the y-cache.
    ``fused``
        Internal nodes whose SpMM -> eMA pair runs as ONE fused CUDA
        kernel (``kernels/fused``): the passive child table is consumed
        directly tile-by-tile and the ``C(k,t_p) x N`` neighbor-sum table is
        never materialized — the model charges such a step no y rows at all.
        Fused nodes bypass the y-cache; a node listed in both ``chunks`` and
        ``fused`` is treated as chunked (chunking wins, it exists because
        even the fused footprint exceeded budget).
    ``fused_groups``
        Disjoint tuples of ``fused`` nodes sharing ONE passive child that
        run as a single shared-passive launch: the members sit consecutively
        in ``order`` and all their tables materialize at the group's first
        member's step (the leader), with the SpMM leg paid once for the
        whole group. Every group member must also be listed in ``fused``
        (liveness treats members as direct passive consumers either way).
    ``passive_cache``
        Whether the walk materializes/caches the passive transform
        (SpMM / hoisted neighbor sum). False for FASCIA, whose neighbor
        sweep lives inside the split loop (paper §3.1).
    ``keep``
        Extra output nodes (beyond the implicit last node) that are never
        freed — fused multi-template plans keep every template's root table
        so :meth:`PlanExecutor.run` can return all of them.
    """

    order: tuple[int, ...]
    free_tables: tuple[tuple[int, ...], ...]
    free_y: tuple[tuple[int, ...], ...]
    chunks: tuple[tuple[int, int], ...] = ()
    passive_cache: bool = True
    keep: tuple[int, ...] = ()
    fused: tuple[int, ...] = ()
    fused_groups: tuple[tuple[int, ...], ...] = ()

    @property
    def chunk_map(self) -> dict[int, int]:
        return dict(self.chunks)

    @property
    def fused_set(self) -> frozenset[int]:
        return frozenset(self.fused)

    @property
    def group_of(self) -> dict[int, tuple[int, ...]]:
        """Member node index -> its shared-passive group tuple."""
        return {m: grp for grp in self.fused_groups for m in grp}


@dataclasses.dataclass(frozen=True)
class ExecutionChoice:
    """What the memory model decided for one (plan, graph, budget)."""

    batch_size: int
    schedule: Schedule
    peak_bytes_per_coloring: int   # modeled, batch=1
    budget_bytes: int
    fits: bool                     # batch_size colorings fit under budget

    @property
    def peak_bytes(self) -> int:
        return self.peak_bytes_per_coloring * self.batch_size


# --------------------------------------------------------------------------
# liveness
# --------------------------------------------------------------------------
def _validate_order(plan, order) -> dict[int, int]:
    pos = {idx: s for s, idx in enumerate(order)}
    if sorted(pos) != list(range(plan.n_nodes)) or len(order) != plan.n_nodes:
        raise ValueError("order must be a permutation of plan node indices")
    for idx, node in enumerate(plan.nodes):
        if not node.is_leaf:
            if pos[node.active] >= pos[idx] or pos[node.passive] >= pos[idx]:
                raise ValueError(f"order is not topological at node {idx}")
    return pos


def _regroup_order(order, groups):
    """Move each group's members so they sit consecutively at the position
    of the group's LATEST member (ascending by original position). Children
    of the moved members and consumers of any member can be violated by the
    move — the caller re-validates with :func:`_validate_order` and drops
    groups whose regrouped order is not topological.
    """
    pos = {i: s for s, i in enumerate(order)}
    anchor_of: dict[int, tuple[int, ...]] = {}
    member: set[int] = set()
    for grp in groups:
        anchor = max(grp, key=lambda i: pos[i])
        anchor_of[anchor] = tuple(sorted(grp, key=lambda i: pos[i]))
        member.update(grp)
    out: list[int] = []
    for i in order:
        if i in anchor_of:
            out.extend(anchor_of[i])
        elif i not in member:
            out.append(i)
    return tuple(out)


def liveness(plan, order, *, passive_cache: bool = True,
             chunks: dict[int, int] | None = None,
             keep: tuple[int, ...] = (),
             fused: tuple[int, ...] = (),
             ) -> tuple[tuple[tuple[int, ...], ...],
                        tuple[tuple[int, ...], ...]]:
    """Last-use analysis -> (free_tables, free_y), parallel to ``order``.

    A node table's life ends at the latest of: every step consuming it as
    the *active* child; every chunked/fused/uncached step consuming it as the
    *passive* child directly; the step that converts it into its cached
    y-entry (the first unchunked passive consumer in ``order``). A y-cache
    entry dies at its last unchunked passive consumer. The root table is
    never freed (it is the result); neither is any node in ``keep`` —
    the extra output roots of a fused multi-template plan.
    """
    pos = _validate_order(plan, order)
    cmap = dict(chunks or {})
    fset = frozenset(fused)
    n = plan.n_nodes
    table_last = {i: pos[i] for i in range(n)}
    y_steps: dict[int, list[int]] = {}
    for idx, node in enumerate(plan.nodes):
        if node.is_leaf:
            continue
        s = pos[idx]
        table_last[node.active] = max(table_last[node.active], s)
        direct = (not passive_cache) or cmap.get(idx, 1) > 1 or idx in fset
        if direct:
            table_last[node.passive] = max(table_last[node.passive], s)
        else:
            y_steps.setdefault(node.passive, []).append(s)
    y_last: dict[int, int] = {}
    for p, steps in y_steps.items():
        # the table is consumed where its y entry is created (min step);
        # the y entry itself lives until its last consumer (max step)
        table_last[p] = max(table_last[p], min(steps))
        y_last[p] = max(steps)
    keepset = {n - 1} | set(keep)
    free_tables: list[tuple[int, ...]] = [() for _ in order]
    free_y: list[tuple[int, ...]] = [() for _ in order]
    for i, last in table_last.items():
        if i not in keepset:
            free_tables[last] = free_tables[last] + (i,)
    for p, last in y_last.items():
        free_y[last] = free_y[last] + (p,)
    return tuple(free_tables), tuple(free_y)


# --------------------------------------------------------------------------
# the analytic memory model (row units; bytes = rows * n * itemsize * batch)
# --------------------------------------------------------------------------
def _step_peaks(plan, k: int, order, free_tables, free_y, *,
                passive_cache: bool, chunks: dict[int, int],
                fused: frozenset[int] = frozenset(),
                fused_groups: tuple[tuple[int, ...], ...] = (),
                pair_block: int = PAIR_BLOCK) -> list[int]:
    """Modeled live table rows at each step of the walk (working buffers
    included). Mirrors :meth:`PlanExecutor.run` exactly, including the
    mid-step release of a passive table right after its y entry is built
    and the all-members-at-once materialization of shared-passive groups."""
    rows = [comb(k, nd.size) for nd in plan.nodes]
    group_of = {m: grp for grp in fused_groups for m in grp}
    leaf_idxs = [i for i, nd in enumerate(plan.nodes) if nd.is_leaf]
    free_step: dict[int, int] = {}
    for s, fr in enumerate(free_tables):
        for i in fr:
            free_step[i] = s
    # all leaf tables alias ONE (k, N) one-hot buffer; it dies when the
    # last leaf index does (the root, never freed, pins it forever)
    leaf_death = max((free_step.get(i, len(order)) for i in leaf_idxs),
                    default=-1)
    live_t: dict[int, int] = {}    # internal-node idx -> rows
    leaf_live = False
    live_y: dict[int, int] = {}
    peaks: list[int] = []

    def cur() -> int:
        return sum(live_t.values()) + (k if leaf_live else 0) \
            + sum(live_y.values())

    for step, idx in enumerate(order):
        node = plan.nodes[idx]
        if node.is_leaf:
            leaf_live = True
            peaks.append(cur())
        else:
            out_r = rows[idx]
            q = chunks.get(idx, 1)
            if q > 1:
                # chunked: m_a and m_p stay live throughout; the extras are
                # one passive chunk, one pair-block term buffer, the output
                chunk_r = -(-rows[node.passive] // q)
                peaks.append(cur() + chunk_r + pair_block + out_r)
            elif idx in group_of:
                # shared-passive group: every member's table materializes at
                # the leader step (one launch); later member steps add nothing
                grp = group_of[idx]
                if idx not in live_t and not any(m in live_t for m in grp):
                    peaks.append(cur() + sum(rows[m] for m in grp))
                    for m in grp:
                        live_t[m] = rows[m]
                else:
                    peaks.append(cur())
            elif idx in fused:
                # fused SpMM->eMA kernel: the neighbor-sum table lives only
                # in shared memory — no device rows beyond the output table
                peaks.append(cur() + out_r)
            elif not passive_cache:
                # FASCIA direct combine: the per-split neighbor sweep uses
                # a working buffer as wide as the output
                peaks.append(cur() + 2 * out_r)
            else:
                p = node.passive
                created = p not in live_y
                spmm_peak = cur() + (rows[p] if created else 0)
                if created:
                    live_y[p] = rows[p]
                    # mid-step release: the passive table dies here if this
                    # was its last use (PlanExecutor frees it pre-eMA)
                    if free_step.get(p) == step and p != node.active \
                            and not plan.nodes[p].is_leaf:
                        live_t.pop(p, None)
                peaks.append(max(spmm_peak, cur() + out_r))
            live_t[idx] = out_r
        for i in free_tables[step]:
            if not plan.nodes[i].is_leaf:
                live_t.pop(i, None)
        for p2 in free_y[step]:
            live_y.pop(p2, None)
        if leaf_live and step >= leaf_death:
            leaf_live = False
    return peaks


def simulate_peak_rows(plan, k: int, schedule: Schedule,
                       pair_block: int = PAIR_BLOCK) -> int:
    """Modeled peak live table rows (1 row = one length-N float vector)."""
    peaks = _step_peaks(plan, k, schedule.order, schedule.free_tables,
                        schedule.free_y, passive_cache=schedule.passive_cache,
                        chunks=schedule.chunk_map, fused=schedule.fused_set,
                        fused_groups=schedule.fused_groups,
                        pair_block=pair_block)
    return max(peaks) if peaks else 0


def peak_table_bytes(plan, k: int, n: int, batch: int = 1,
                     dtype=np.float32, schedule: Schedule | None = None
                     ) -> int:
    """Modeled peak live table bytes for one scheduled plan execution.

    ``batch`` colorings multiply every table (the leaf one-hot included);
    the static int32 split tables are negligible and excluded.
    """
    if schedule is None:
        schedule = compute_schedule(plan, k)
    itemsize = np.dtype(dtype).itemsize
    return simulate_peak_rows(plan, k, schedule) * n * itemsize * batch


def keep_everything_bytes(plan, k: int, n: int, batch: int = 1,
                          dtype=np.float32, passive_cache: bool = True
                          ) -> int:
    """Footprint of the pre-executor walk: every node table and every
    y-cache SpMM entry stays live until the end of the plan."""
    rows = 0
    leaf_seen = False
    y_seen: set[int] = set()
    for node in plan.nodes:
        if node.is_leaf:
            if not leaf_seen:      # all leaves alias one (k, N) one-hot
                rows += k
                leaf_seen = True
            continue
        rows += comb(k, node.size)
        if passive_cache and node.passive not in y_seen:
            rows += comb(k, plan.nodes[node.passive].size)
            y_seen.add(node.passive)
    itemsize = np.dtype(dtype).itemsize
    return rows * n * itemsize * batch


# --------------------------------------------------------------------------
# scheduling
# --------------------------------------------------------------------------
def _greedy_order(plan, k: int, *, passive_cache: bool,
                  chunks: dict[int, int],
                  keep: tuple[int, ...] = (),
                  fused: frozenset[int] = frozenset()) -> list[int]:
    """Greedy list scheduling: repeatedly evaluate the ready internal node
    whose modeled step peak (then post-step live size) is smallest.

    Leaves cost one shared (k, N) buffer and are emitted first. The final
    free lists always come from :func:`liveness` on the chosen order; the
    reference counts here only steer the choice.
    """
    rows = [comb(k, nd.size) for nd in plan.nodes]
    leaf_idxs = [i for i, nd in enumerate(plan.nodes) if nd.is_leaf]
    internal = [i for i, nd in enumerate(plan.nodes) if not nd.is_leaf]

    def buf(i: int):
        return "leaf" if plan.nodes[i].is_leaf else i

    # table-buffer reference counts: active uses + direct passive uses +
    # one per distinct cached passive child (consumed at y creation)
    refs: dict[object, int] = {}
    y_refs: dict[int, int] = {}
    for idx in internal:
        node = plan.nodes[idx]
        refs[buf(node.active)] = refs.get(buf(node.active), 0) + 1
        direct = (not passive_cache) or chunks.get(idx, 1) > 1 \
            or idx in fused
        if direct:
            refs[buf(node.passive)] = refs.get(buf(node.passive), 0) + 1
        else:
            if node.passive not in y_refs:
                refs[buf(node.passive)] = refs.get(buf(node.passive), 0) + 1
            y_refs[node.passive] = y_refs.get(node.passive, 0) + 1
    # kept outputs (fused-plan roots) are never droppable: pin their buffers
    for i in keep:
        refs[buf(i)] = refs.get(buf(i), 0) + plan.n_nodes + 1

    live_t: dict[object, int] = {}
    if leaf_idxs:
        live_t["leaf"] = k
    live_y: dict[int, int] = {}

    def step_cost(idx: int) -> tuple[int, int]:
        """(step peak, live rows after) if ``idx`` ran next — no mutation."""
        node = plan.nodes[idx]
        cur = sum(live_t.values()) + sum(live_y.values())
        out_r = rows[idx]
        q = chunks.get(idx, 1)
        if q > 1:
            peak = cur + -(-rows[node.passive] // q) + PAIR_BLOCK + out_r
        elif idx in fused:
            peak = cur + out_r
        elif not passive_cache:
            peak = cur + 2 * out_r
        else:
            creates = node.passive not in live_y
            peak = cur + (rows[node.passive] if creates else 0) + out_r
        after = cur + out_r
        direct = (not passive_cache) or q > 1 or idx in fused
        dead: set[object] = set()
        if refs.get(buf(node.active), 0) == 1:
            dead.add(buf(node.active))
        if direct or node.passive not in live_y:
            if refs.get(buf(node.passive), 0) == 1:
                dead.add(buf(node.passive))
        if not direct and y_refs.get(node.passive, 0) == 1 \
                and node.passive in live_y:
            after -= live_y[node.passive]
        for b in dead:
            after -= live_t.get(b, 0)
        return peak, after

    order = list(leaf_idxs)
    done = set(leaf_idxs)
    remaining = set(internal)
    while remaining:
        ready = [i for i in remaining
                 if plan.nodes[i].active in done
                 and plan.nodes[i].passive in done]
        pick = min(ready, key=lambda i: step_cost(i) + (i,))
        node = plan.nodes[pick]
        q = chunks.get(pick, 1)
        direct = (not passive_cache) or q > 1 or pick in fused

        def consume(b: object) -> None:
            refs[b] = refs.get(b, 0) - 1
            if refs[b] <= 0:
                live_t.pop(b, None)

        if direct:
            consume(buf(node.passive))
        else:
            if node.passive not in live_y:
                live_y[node.passive] = rows[node.passive]
                consume(buf(node.passive))
            y_refs[node.passive] -= 1
            if y_refs[node.passive] <= 0:
                live_y.pop(node.passive, None)
        consume(buf(node.active))
        live_t[pick] = rows[pick]
        order.append(pick)
        done.add(pick)
        remaining.discard(pick)
    return order


def compute_schedule(plan, k: int | None = None, *,
                     passive_cache: bool = True,
                     chunks: dict[int, int] | None = None,
                     order_mode: str = "auto",
                     keep: tuple[int, ...] = (),
                     fused: tuple[int, ...] = (),
                     fused_groups: tuple[tuple[int, ...], ...] = ()
                     ) -> Schedule:
    """Build a :class:`Schedule` for ``plan``.

    ``order_mode``: ``"program"`` keeps the plan's own post-order;
    ``"greedy"`` uses the min-peak list scheduler; ``"auto"`` (default)
    simulates both and keeps the one with the smaller modeled peak.
    ``keep`` lists extra output nodes never to free (fused-plan roots);
    ``fused`` lists nodes running the fused SpMM->eMA kernel (their
    neighbor-sum table never reaches device memory — see
    :class:`Schedule`).
    ``fused_groups`` lists shared-passive groups over ``fused`` nodes: each
    candidate order is regrouped so members run consecutively (one launch);
    a group whose regrouped order stops being topological — some member's
    consumer sits between the members — is dropped for that candidate, and
    its members leave ``fused`` entirely (back to the y-cache path, which
    still pays the shared SpMM once; singleton-fusing them would pay it per
    consumer).
    """
    k = k or plan.k
    cmap = dict(chunks or {})
    keep = tuple(sorted(set(keep)))
    fused = tuple(sorted(set(fused)))
    fset = frozenset(fused)
    candidates: list[tuple[int, ...]] = []
    if order_mode in ("program", "auto"):
        candidates.append(tuple(range(plan.n_nodes)))
    if order_mode in ("greedy", "auto"):
        candidates.append(tuple(_greedy_order(
            plan, k, passive_cache=passive_cache, chunks=cmap, keep=keep,
            fused=fset)))
    if not candidates:
        raise ValueError(f"unknown order_mode {order_mode!r}")
    best: Schedule | None = None
    best_peak: int | None = None
    for order in candidates:
        accepted: list[tuple[int, ...]] = []
        for grp in fused_groups:
            gset = set(grp)
            if any(plan.nodes[m].active in gset or plan.nodes[m].passive
                   in gset for m in grp):
                # a single launch cannot consume its own outputs
                continue
            trial = _regroup_order(order, accepted + [tuple(grp)])
            try:
                _validate_order(plan, trial)
            except ValueError:
                continue
            accepted.append(tuple(grp))
        if accepted:
            order = _regroup_order(order, accepted)
        kept_members = {m for grp in accepted for m in grp}
        dropped = {m for grp in fused_groups for m in grp} - kept_members
        fused_c = tuple(i for i in fused if i not in dropped)
        ft, fy = liveness(plan, order, passive_cache=passive_cache,
                          chunks=cmap, keep=keep, fused=fused_c)
        sched = Schedule(order=order, free_tables=ft, free_y=fy,
                         chunks=tuple(sorted(cmap.items())),
                         passive_cache=passive_cache, keep=keep,
                         fused=fused_c, fused_groups=tuple(accepted))
        peak = simulate_peak_rows(plan, k, sched)
        if best_peak is None or peak < best_peak:
            best, best_peak = sched, peak
    return best


# --------------------------------------------------------------------------
# budget -> (batch size, schedule)
# --------------------------------------------------------------------------
def pick_execution(plan, k: int, n: int, *,
                   memory_budget_bytes: int | None = None,
                   dtype=np.float32, max_batch: int = MAX_AUTO_BATCH,
                   passive_cache: bool = True,
                   allow_chunking: bool = True,
                   keep: tuple[int, ...] = (),
                   fused: tuple[int, ...] = (),
                   fused_groups: tuple[tuple[int, ...], ...] = ()
                   ) -> ExecutionChoice:
    """Turn one ``memory_budget_bytes`` knob into (batch size, schedule).

    The batch is the largest B with ``B * peak(batch=1) <= budget`` (capped
    at ``max_batch``). ``fused`` nodes run the fused SpMM->eMA kernel and
    are charged no neighbor-sum rows, so the same budget admits a larger
    batch. If even B=1 exceeds the budget and ``allow_chunking``,
    passive-axis chunk counts are doubled node by node — always at the step
    realizing the current peak — until the modeled peak fits or every
    chunkable node is at single-row chunks (the irreducible floor of
    active + passive + output tables; the choice is then best-effort with
    ``fits=False``). Shared-passive ``fused_groups`` survive only on the
    unchunked path: once chunking starts, groups are dropped (their members
    stay singleton-fused) — a group step materializes every member's output
    at once, the opposite of what a budget squeeze wants.
    """
    budget = memory_budget_bytes if memory_budget_bytes is not None \
        else DEFAULT_MEMORY_BUDGET_BYTES
    itemsize = np.dtype(dtype).itemsize
    fused = tuple(sorted(set(fused)))
    sched = compute_schedule(plan, k, passive_cache=passive_cache, keep=keep,
                             fused=fused, fused_groups=fused_groups)
    per1 = simulate_peak_rows(plan, k, sched) * n * itemsize
    if per1 <= budget:
        batch = max(1, min(max_batch, budget // max(per1, 1)))
        return ExecutionChoice(int(batch), sched, per1, budget, True)
    if not allow_chunking:
        return ExecutionChoice(1, sched, per1, budget, False)

    # chunked path: drop the shared groups AND their members from fused
    # (members return to the y-cache — one SpMM per shared passive, just
    # materialized in device memory; singleton-fusing them would pay it per
    # consumer)
    if fused_groups:
        members = {m for grp in fused_groups for m in grp}
        fused = tuple(i for i in fused if i not in members)

    budget_rows = budget // (n * itemsize)
    cmap: dict[int, int] = {}

    def evaluate(chunk_map):
        s = compute_schedule(plan, k, passive_cache=passive_cache,
                             chunks=chunk_map, keep=keep, fused=fused)
        p = _step_peaks(plan, k, s.order, s.free_tables, s.free_y,
                        passive_cache=passive_cache, chunks=s.chunk_map,
                        fused=s.fused_set)
        return s, p, max(p)

    sched, peaks, peak = evaluate(cmap)
    while peak > budget_rows:
        # try chunking the node at the hottest step; accept only strict
        # improvements (chunking keeps m_a AND m_p live through the step,
        # so it can lose when the passive table is narrow)
        improved = False
        for s_idx in sorted(range(len(peaks)), key=lambda s: -peaks[s]):
            hot = sched.order[s_idx]
            node = plan.nodes[hot]
            if node.is_leaf:
                continue
            p_rows = comb(k, plan.nodes[node.passive].size)
            q = cmap.get(hot, 1)
            if q >= p_rows:
                continue
            for q_new in (min(2 * q, p_rows), p_rows):
                trial = dict(cmap)
                trial[hot] = q_new
                t_sched, t_peaks, t_peak = evaluate(trial)
                if t_peak < peak:
                    cmap, sched, peaks, peak = trial, t_sched, t_peaks, t_peak
                    improved = True
                    break
            if improved:
                break
        if not improved:   # irreducible floor for every hot step
            break
    per1 = peak * n * itemsize
    return ExecutionChoice(1, sched, per1, budget, per1 <= budget)


# --------------------------------------------------------------------------
# the executor
# --------------------------------------------------------------------------
class PlanExecutor:
    """Drives one scheduled plan walk; engine-specific math via callbacks.

    ``run(leaf, passive_op=, combine=, combine_direct=, on_step=)``:

    * ``leaf``: the shared leaf table (every leaf node aliases it);
    * ``passive_op(p_idx, m_p)``: passive transform (SpMM / neighbor sum),
      cached per distinct passive child — required iff the schedule has
      ``passive_cache=True``;
    * ``combine(idx, m_a, y_p)``: eMA of the active table with the cached
      transform;
    * ``combine_direct(idx, m_a, m_p)``: used for chunked nodes, fused
      SpMM->eMA nodes, and cache-less walks (FASCIA) — consumes the passive
      *table* directly (the engine picks chunked/fused kernel per node);
    * ``combine_group(members, m_as, m_p)``: one shared-passive launch for a
      whole ``fused_groups`` group — returns one table per member. Required
      iff the schedule carries groups; invoked at the group's first member's
      step, later member steps only process their frees;
    * ``on_step(step, live_bytes)``: optional instrumentation hook called
      twice per step (post-compute and post-free) with the live table bytes
      (unique buffers only), so measured peaks can be checked against
      :func:`peak_table_bytes`.

    Buffers are dropped at their statically computed last use, which
    returns their device memory to PyTorch's caching allocator at once.
    """

    def __init__(self, plan, schedule: Schedule):
        _validate_order(plan, schedule.order)
        self.plan = plan
        self.schedule = schedule

    @staticmethod
    def _live_bytes(tables: dict, y: dict) -> int:
        uniq: dict[int, object] = {}
        for v in list(tables.values()) + list(y.values()):
            if v is not None:
                uniq[id(v)] = v
        # torch tensors: np.dtype() does not take a torch dtype
        return sum(v.numel() * v.element_size() for v in uniq.values())

    def run(self, leaf, *, passive_op=None, combine=None,
            combine_direct=None, combine_group=None, on_step=None,
            outputs=None):
        """Walk the schedule; returns the root table, or — when ``outputs``
        (a tuple of node indices) is given — one table per output index.
        Every non-root output must be in the schedule's ``keep`` set, i.e.
        the schedule must have been built with ``keep=`` covering it."""
        plan, sched = self.plan, self.schedule
        chunks = sched.chunk_map
        fset = sched.fused_set
        group_of = sched.group_of
        if sched.passive_cache and passive_op is None:
            raise ValueError("schedule expects a passive_op "
                             "(built with passive_cache=True)")
        if not sched.passive_cache and combine_direct is None:
            raise ValueError("cache-less schedule needs combine_direct")
        if group_of and combine_group is None:
            raise ValueError("schedule carries fused_groups; run() needs a "
                             "combine_group callback")
        tables: dict[int, object] = {}
        y: dict[int, object] = {}
        root_idx = plan.n_nodes - 1
        keepset = {root_idx} | set(sched.keep)
        if outputs is not None:
            missing = [i for i in outputs if i not in keepset]
            if missing:
                raise ValueError(
                    f"outputs {missing} are not kept by this schedule; "
                    "build it with compute_schedule(..., keep=...)")
        for step, idx in enumerate(sched.order):
            node = plan.nodes[idx]
            if node.is_leaf:
                tables[idx] = leaf
            elif idx in group_of and chunks.get(idx, 1) <= 1:
                grp = group_of[idx]
                if idx not in tables:
                    # leader step: one launch materializes EVERY member
                    with _tracing.span("plan.node", idx=idx, size=node.size,
                                       mode="fused_shared", group=len(grp)):
                        outs_g = combine_group(
                            grp, [tables[plan.nodes[m].active] for m in grp],
                            tables[node.passive])
                    for m, t in zip(grp, outs_g):
                        tables[m] = t
                # non-leader member steps: table already present, only frees
            else:
                m_a = tables[node.active]
                direct = (not sched.passive_cache) \
                    or chunks.get(idx, 1) > 1 or idx in fset
                mode = ("chunked" if chunks.get(idx, 1) > 1
                        else "fused" if idx in fset
                        else "direct" if direct else "cached")
                # kernel launches are asynchronous: these spans expose
                # per-node plan structure and launch time, not device
                # time — that belongs to the engine's dispatch span
                with _tracing.span("plan.node", idx=idx, size=node.size,
                                   mode=mode):
                    if direct:
                        tables[idx] = combine_direct(idx, m_a,
                                                     tables[node.passive])
                    else:
                        if node.passive not in y:
                            y[node.passive] = passive_op(
                                node.passive, tables[node.passive])
                            # mid-step release: the passive table may die
                            # the moment its y entry exists
                            if node.passive in sched.free_tables[step] \
                                    and node.passive != node.active:
                                tables.pop(node.passive, None)
                        tables[idx] = combine(idx, m_a, y[node.passive])
                m_a = None
            if on_step is not None:
                on_step(step, self._live_bytes(tables, y))
            for i in sched.free_tables[step]:
                if i not in keepset:
                    tables.pop(i, None)
            for p in sched.free_y[step]:
                y.pop(p, None)
            if on_step is not None:
                on_step(step, self._live_bytes(tables, y))
        if outputs is not None:
            return tuple(tables[i] for i in outputs)
        return tables[root_idx]
