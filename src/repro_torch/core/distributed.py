"""Distributed PGBSC over a (pod, data, model) mesh of ``torch.distributed``
ranks.

A copy of the JAX package's ``core/distributed.py`` with
``torch.distributed`` in place of ``shard_map`` and JAX's collectives:

* vertices -> ``data`` axis. The SpMM is a **ring**: each data shard owns
  a block of destination vertices and, for every source block, the edges
  from that block into its own (:func:`build_ring_edges`). Count-table
  blocks rotate around the ring (``batch_isend_irecv`` to the previous
  shard, from the next) while each rank adds the contribution of the
  block it holds: one gather SpMM (``csrc/spmm_gather.cu``) on that
  ``(my shard, owner block)`` piece. The next block's transfer is posted
  before the step's SpMM, so the two overlap.
* color combinations -> ``model`` axis. Every table is stored as the
  rank's slice of its combination rows, padded to a multiple of the axis.
  The eMA (``csrc/ema.cu``) either all-gathers both children over
  ``model`` and computes the rank's output rows, or — when the active
  child is wider than the output — computes the split terms whose active
  row the rank owns for every output row and reduce-scatters the partial
  sums (the reference's cost rule, :func:`shard_plan`).
* color-coding iterations -> ``pod`` axis. Each pod runs its own
  coloring, derived from ``fold_in(PRNGKey(0), seed * 1_000_003 + it)``
  globally and sliced, so per-iteration sums do not depend on the mesh;
  pods exchange only their sums.

Tables are ``(C, N)`` in float32, sharded (model, data), both dimensions
zero-padded to the mesh multiples; padded combination rows are masked out
of the root's sum, padding vertices get a color no leaf row matches. A
coloring's sum is the float64 sum of the root table, all-reduced in
float64 and then kept in float32, as ``CountingEngine``'s totals: exact
for these integer tables below 2^53, whatever order the ranks add in.

Every rank of the mesh calls the same methods with the same arguments:
the ring and the collectives need all of them.
"""

from __future__ import annotations

import dataclasses
from math import comb

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import colorsets as cs
from repro_torch.core import executor as pexec
from repro_torch.core.templates import TreeTemplate, as_template
from repro_torch.device import faking, resolve_device
from repro_torch.graph.coloring import _fold_in, _key, _randint
from repro_torch.graph.structure import Graph
from repro_torch.kernels.ema import ops as ema_ops
from repro_torch.kernels.spmm import ops as spmm_ops

__all__ = ["DistributedPgbsc", "build_ring_edges", "coloring_for_seed",
           "shard_plan", "NodeShard", "local_splits", "pod_rounds"]

# an iteration's coloring stream id is seed * _STREAM + iteration, an int32
_STREAM = 1_000_003
_INT32 = (-(1 << 31), 1 << 31)


def _int32(value: int) -> int:
    """``value`` if it is an int32; else ``OverflowError``, where the
    reference's ``jnp.asarray(..., jnp.int32)`` raises (no silent wrap)."""
    value = int(value)
    if not _INT32[0] <= value < _INT32[1]:
        raise OverflowError(f"Python integer {value} out of bounds for "
                            f"int32")
    return value


def _stream_id(seed: int, iteration: int) -> int:
    """The reference's int32 stream id of an iteration's coloring."""
    return _int32(int(seed) * _STREAM + int(iteration))


def coloring_for_seed(seed, n_pad: int, n_true: int, k: int,
                      device=None) -> torch.Tensor:
    """Global ``(n_pad,)`` int32 coloring for a stream id:
    ``randint(fold_in(PRNGKey(0), seed), (n_pad,), 0, k)``, bit for bit
    with the reference, and color ``k + 1`` (no leaf row's) on the padding
    vertices ``n_true:``. Mesh-shape independent. ``seed`` is a uint32 or
    an int32 (read as its bits, as the reference's int32 stream ids are);
    anything else raises ``OverflowError``. A 0-d integer tensor on
    ``device`` is taken as it is, never read on the host (a traced step's
    seed). ``device=None`` is CUDA."""
    device = resolve_device(device)
    if isinstance(seed, torch.Tensor):
        data = seed.to(torch.int64)
    else:
        seed = int(seed)
        if not _INT32[0] <= seed < 1 << 32:
            raise OverflowError(f"Python integer {seed} out of bounds for "
                                f"uint32")
        data = torch.tensor(seed, dtype=torch.int64, device=device)
    key = _fold_in(_key(0, device), data)
    colors = _randint(key.reshape(1, 2), n_pad, k)[0]
    vid = torch.arange(n_pad, device=device)
    return torch.where(vid < n_true, colors,
                       torch.full_like(colors, k + 1))


def build_ring_edges(g: Graph, n_shards: int,
                     pad_vertices_to: int = 128) -> dict:
    """Per-(dst shard, src block) padded edge arrays for the ring SpMM.

    Returns arrays of shape (n_shards, n_shards, e_max):
      src_local[d, s] — src offset within block s for edges into dst shard d
      dst_local[d, s] — dst offset within shard d
      mask[d, s]      — 1.0 for real edges (the first ones of each row)
    plus n_pad (the padded vertex count; n_pad % (n_shards*pad_vertices_to)
    == 0), block and e_max. The reference's arrays, array for array.
    """
    block = -(-g.n // (n_shards * pad_vertices_to)) * pad_vertices_to
    n_pad = block * n_shards
    src, dst = g.edges_by_dst
    d_shard = dst // block
    s_block = src // block
    counts = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(counts, (d_shard, s_block), 1)
    e_max = max(int(counts.max()), 1)

    src_local = np.zeros((n_shards, n_shards, e_max), np.int32)
    dst_local = np.zeros((n_shards, n_shards, e_max), np.int32)
    mask = np.zeros((n_shards, n_shards, e_max), np.float32)
    if len(src):
        order = np.lexsort((s_block, d_shard))
        src_s, dst_s = src[order], dst[order]
        ds, ss = d_shard[order], s_block[order]
        # position within each (dst shard, src block) group
        key = ds * n_shards + ss
        change = np.r_[True, key[1:] != key[:-1]]
        group_start = np.maximum.accumulate(
            np.where(change, np.arange(len(key)), 0))
        pos = np.arange(len(key)) - group_start
        src_local[ds, ss, pos] = (src_s - ss * block).astype(np.int32)
        dst_local[ds, ss, pos] = (dst_s - ds * block).astype(np.int32)
        mask[ds, ss, pos] = 1.0
    return {
        "src_local": src_local, "dst_local": dst_local, "mask": mask,
        "n_pad": n_pad, "block": block, "e_max": e_max,
    }


@dataclasses.dataclass
class NodeShard:
    """A plan node's padded layout over ``d_model`` shards: ``width`` =
    C(k, t) combination rows padded to ``width_pad``; an internal node's
    split tables ``ia``/``ip`` padded to ``(width_pad, L)`` with zero rows,
    and the eMA form over ``model`` (``"gather"`` or ``"scatter"``)."""

    width: int
    width_pad: int
    ia: np.ndarray | None = None
    ip: np.ndarray | None = None
    active: int | None = None
    passive: int | None = None
    collective: str | None = None


def shard_plan(plan, k: int, d_model: int) -> list[NodeShard]:
    """Each node's :class:`NodeShard` for a ``d_model``-way ``model``
    axis. The eMA form is the reference's rule, bytes moved over
    ``model``: gathering both children moves ``Ca_pad + Cp_pad`` rows; the
    scatter form gathers the passive child and reduce-scatters the output,
    which costs about twice an all-gather of its rows, ``Cp_pad + 2 *
    S_pad``; the scatter form is taken when it is strictly cheaper."""
    out: list[NodeShard] = []
    for node in plan.nodes:
        width = comb(k, node.size)
        width_pad = -(-width // d_model) * d_model
        if node.is_leaf:
            out.append(NodeShard(width, width_pad))
            continue
        ia, ip = cs.split_tables(k, node.size, plan.nodes[node.active].size)
        ia_pad = np.zeros((width_pad, ia.shape[1]), np.int32)
        ip_pad = np.zeros((width_pad, ip.shape[1]), np.int32)
        ia_pad[:width] = ia
        ip_pad[:width] = ip
        gather_cost = out[node.active].width_pad + out[node.passive].width_pad
        scatter_cost = out[node.passive].width_pad + 2 * width_pad
        out.append(NodeShard(
            width, width_pad, ia_pad, ip_pad, node.active, node.passive,
            "scatter" if scatter_cost < gather_cost else "gather"))
    return out


def local_splits(meta: list[NodeShard], idx: int, d_model: int,
                 my_model: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``(IA, IP)`` tables model shard ``my_model`` passes to the eMA
    kernel for internal node ``idx``: for the gather form, its slice of the
    padded tables' rows (its output rows, against both children
    gathered); for the scatter form, every output row against its own
    ``a_rows`` rows of the active child and the passive child gathered,
    each term whose active row another shard owns pointed at active row 0
    and passive row ``Cp_pad`` — the zero row appended after the gathered
    passive — so it adds an exact 0. (At ``d_model`` 1 the shard owns
    every term and nothing points there.) Contiguous int32."""
    m = meta[idx]
    if m.collective == "gather":
        rows = m.width_pad // d_model
        lo = my_model * rows
        ia, ip = m.ia[lo:lo + rows], m.ip[lo:lo + rows]
    else:
        a_rows = meta[m.active].width_pad // d_model
        lo = my_model * a_rows
        own = (m.ia >= lo) & (m.ia < lo + a_rows)
        ia = np.where(own, m.ia - lo, 0)
        ip = np.where(own, m.ip, meta[m.passive].width_pad)
    return (np.ascontiguousarray(ia, dtype=np.int32),
            np.ascontiguousarray(ip, dtype=np.int32))


def pod_rounds(ids: list, n_pods: int) -> list[list]:
    """``ids`` in rounds of ``n_pods``, one per pod, the last round
    padded with the last id (a padded pod's sum is dropped): ``ceil(len /
    n_pods)`` rounds, so no more plan walks than pods left idle in the
    last round."""
    rounds = [list(ids[i:i + n_pods]) for i in range(0, len(ids), n_pods)]
    if rounds:
        rounds[-1] += [rounds[-1][-1]] * (n_pods - len(rounds[-1]))
    return rounds


class DistributedPgbsc:
    """PGBSC sharded over a ``DeviceMesh`` with ``("data", "model")`` [+ a
    leading ``"pod"``] (``launch/mesh.make_mesh``).

    Each rank holds its own shard only: its ``data`` row of the ring's
    edge arrays (one gather operand per source block), its ``model`` slice
    of every table, ``(width_pad // d_model, block)``, and the padded split
    tables it needs. The device is the mesh's (a CUDA mesh without a card
    raises ``RuntimeError``). ``count_step(seeds)`` evaluates one coloring
    per pod; ``count_iterations`` runs checkpoint batches for the runner
    (``core/runner.distributed_counter``). Colorings run one plan walk
    each, a Python loop over pod rounds: there is no compiled batch to pad
    to (the reference's ``lax.scan`` over ``batch_size`` rounds and its
    memory-budget rule), so a rank holds one coloring's tables at a time.

    ``g=None`` with ``abstract_dims={"n", "e"[, "e_max",
    "hub_segments"]}`` is the dry run's abstract mode (the reference's):
    built inside a ``FakeTensorMode`` over a mesh of a ``"fake"`` process
    group, its ring operands are fake gather operands of the reference's
    shapes (:meth:`_abstract_ring`), its device ``cuda`` with no card, and
    :meth:`count_step_fn` gives the walk to trace
    (``launch/dryrun.trace_pgbsc``).
    """

    def __init__(self, g: Graph | None, template, mesh, *,
                 plan: str = "dedup", abstract_dims: dict | None = None):
        template: TreeTemplate = as_template(template)
        self.template = template
        self.k = template.k
        self.mesh = mesh
        self.axes = tuple(mesh.mesh_dim_names or ())
        if self.axes not in (("data", "model"), ("pod", "data", "model")):
            raise ValueError(f"mesh axes must be ('data', 'model') or "
                             f"('pod', 'data', 'model'), got {self.axes}")
        self.has_pod = len(self.axes) == 3
        self.abstract = g is None
        if self.abstract and abstract_dims is None:
            raise ValueError("pass a Graph, or abstract_dims with 'n' and "
                             "'e' for the dry run's shapes")
        dev = resolve_device(mesh.device_type)
        if dev.type != "cuda":
            self.device = dev
        elif faking():    # a traced step: fake CUDA tensors, no card
            self.device = torch.device("cuda", 0)
        else:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.groups = {a: mesh.get_group(a) for a in self.axes}
        self.d_data = mesh.size(self.axes.index("data"))
        self.d_model = mesh.size(self.axes.index("model"))
        self.n_pods = mesh.size(0) if self.has_pod else 1
        self.my_data = mesh.get_local_rank("data")
        self.my_model = mesh.get_local_rank("model")
        self.my_pod = mesh.get_local_rank("pod") if self.has_pod else 0
        self.plan = {"plain": template.plan, "dedup": template.plan_dedup,
                     "optimized": template.plan_optimized}[plan]
        # the single-device engines' liveness-managed, min-peak walk; each
        # freed buffer here is one rank's slice of a table
        self.exec_schedule = pexec.compute_schedule(self.plan, self.k,
                                                    passive_cache=True)

        if self.abstract:
            self.ring_preps = self._abstract_ring(abstract_dims)
        else:
            self.ring_preps = self._ring(g)
        self.ring_ranks = dist.get_process_group_ranks(self.groups["data"])

        self.meta = shard_plan(self.plan, self.k, self.d_model)
        # the split tables each node's eMA form reads, on the device once
        self.splits = {
            idx: tuple(self._on_device(t)
                       for t in local_splits(self.meta, idx, self.d_model,
                                             self.my_model))
            for idx, m in enumerate(self.meta) if m.collective is not None}

    def _ring(self, g: Graph) -> list:
        """My data row of the ring's edge arrays, as the ring's operand
        for each source block s: the edges of that block into my shard, in
        the arrays' order (the row's first ``counts[s]`` slots)."""
        ring = build_ring_edges(g, self.d_data)
        self.n_pad, self.block = int(ring["n_pad"]), int(ring["block"])
        self.n_true = g.n
        src_l, dst_l = (ring[key][self.my_data]
                        for key in ("src_local", "dst_local"))
        counts = ring["mask"][self.my_data].sum(axis=1).astype(np.int64)
        return [spmm_ops.gather_prep_from_edges(
                    self.block, src_l[s, :counts[s]], dst_l[s, :counts[s]],
                    device=self.device)
                for s in range(self.d_data)]

    def _abstract_ring(self, dims: dict) -> list:
        """The dry run's ring operands (the reference's abstract shapes):
        ``block = ceil(n / (d_data * 128)) * 128`` vertices a shard, and
        for each source block a gather operand of ``e_max`` edges (given,
        else ``1.3 * e / d_data**2 + 1``) with ``hub_segments`` hub
        segments (default 0; hubs of two segments, the fewest a hub has),
        its tensors empty: only their shapes and dtypes are read, under a
        fake mode."""
        n, e = int(dims["n"]), int(dims["e"])
        self.block = -(-n // (self.d_data * 128)) * 128
        self.n_pad = self.block * self.d_data
        self.n_true = n
        e_max = (int(dims["e_max"]) if "e_max" in dims
                 else int(1.3 * e / self.d_data ** 2 + 1))
        n_seg = int(dims.get("hub_segments", 0))
        n_hubs = n_seg // 2
        tile = 128

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=self.device)
        return [spmm_ops.GatherPrep(
                    n=self.block, src=empty(e_max, torch.int32),
                    row_ptr=empty(self.block + 1, torch.int64),
                    tile_ptr=empty(-(-self.block // tile) + 1, torch.int64),
                    tile=tile, hub_degree=spmm_ops.HUB_DEGREE,
                    hub_vertex=empty(n_hubs, torch.int32),
                    hub_seg_ptr=empty(n_hubs + 1, torch.int32),
                    seg=empty((n_seg, 2), torch.int64))
                for _ in range(self.d_data)]

    def _on_device(self, table: np.ndarray) -> torch.Tensor:
        """A host table on the device; in the abstract mode an empty one of
        its shape and dtype."""
        if self.abstract:
            return torch.empty(table.shape, dtype=torch.int32,
                               device=self.device)
        return torch.as_tensor(table, device=self.device)

    def operands(self) -> list:
        """The tensors a rank holds across colorings: its ring operands
        and split tables (a traced step's arguments)."""
        return [t for p in self.ring_preps
                for t in (p.src, p.row_ptr, p.tile_ptr, p.hub_vertex,
                          p.hub_seg_ptr, p.seg)] + [
            t for pair in self.splits.values() for t in pair]

    # ---------------------------------------------------------------- local
    def _my_rows(self, width_pad: int) -> slice:
        rows = width_pad // self.d_model
        return slice(self.my_model * rows, (self.my_model + 1) * rows)

    def collective_choice(self) -> dict[int, str]:
        """``{internal node: "gather" | "scatter"}``, the eMA form each
        node's combine takes over ``model``."""
        return {i: m.collective for i, m in enumerate(self.meta)
                if m.collective is not None}

    def _ring_spmm(self, m_loc: torch.Tensor) -> torch.Tensor:
        """``M @ A`` for my ``(C_loc, block)`` slice of a table: at step s
        the resident block is shard ``(my + s) % D``'s, sent on to shard
        ``my - 1`` while this step's SpMM runs, the partial products
        added in step order."""
        d, my = self.d_data, self.my_data
        group = self.groups["data"]
        to_rank = self.ring_ranks[(my - 1) % d]
        from_rank = self.ring_ranks[(my + 1) % d]
        cur, acc = m_loc.contiguous(), None
        for step in range(d):
            reqs = nxt = None
            if step < d - 1:      # the last step has nothing left to feed
                nxt = torch.empty_like(cur)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, cur, to_rank, group),
                    dist.P2POp(dist.irecv, nxt, from_rank, group)])
            prep = self.ring_preps[(my + step) % d]
            if acc is None:
                acc = spmm_ops.spmm_gather(cur, prep)
            else:   # no name holds a step's product into the next step
                acc.add_(spmm_ops.spmm_gather(cur, prep))
            if reqs is not None:
                for r in reqs:
                    r.wait()
                cur = nxt
        return acc

    def _gather_rows(self, x: torch.Tensor,
                     zero_row: bool = False) -> torch.Tensor:
        """All model shards' rows of a table, in shard order, and with
        ``zero_row`` one row of zeros after them (the scatter form's
        target for the terms another shard owns; at ``d_model`` 1 there
        are none, and ``x`` comes back as it is)."""
        if self.d_model == 1:
            return x
        rows = self.d_model * x.shape[0]
        out = torch.empty((rows + zero_row,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        out[rows:].zero_()
        dist.all_gather_into_tensor(out[:rows], x.contiguous(),
                                    group=self.groups["model"])
        return out

    def _combine(self, idx: int, m_a_loc, y_p_loc) -> torch.Tensor:
        ia, ip = self.splits[idx]
        if self.meta[idx].collective == "gather":
            # my output rows from both children whole
            return ema_ops.ema(self._gather_rows(m_a_loc),
                               self._gather_rows(y_p_loc), ia, ip)
        # the scatter form: the terms whose active row I own, for every
        # output row (the others read the passive's zero row), summed over
        # model and scattered, my slice kept
        part = ema_ops.ema(m_a_loc, self._gather_rows(y_p_loc, True), ia, ip)
        if self.d_model == 1:
            return part
        out = torch.empty((part.shape[0] // self.d_model, part.shape[1]),
                          dtype=part.dtype, device=part.device)
        dist.reduce_scatter_tensor(out, part, group=self.groups["model"])
        return out

    def transient_bytes(self) -> int:
        """The most a rank holds at once beyond the tables the memory
        model counts (``simulate_peak_rows * n_pad * 4 // shards``, each
        table at its output slice): in a combine, the children gathered
        over ``model`` (with the scatter form's zero row) and the scatter
        form's whole-width partial sums before they are reduce-scattered;
        in the ring, the blocks in flight, a step's partial product and
        the gather kernel's scratch. A combine and a ring step never
        overlap, so the larger of the two."""
        combine = 0
        for m in self.meta:
            if m.collective is None or self.d_model == 1:
                continue
            p_pad = self.meta[m.passive].width_pad
            combine = max(combine, self.meta[m.active].width_pad + p_pad
                          if m.collective == "gather"
                          else p_pad + 1 + m.width_pad)
        widest = max(self.meta[m.passive].width_pad for m in self.meta
                     if m.collective is not None) // self.d_model
        # from the second step: the block received, the one receiving
        # (none on the last step) and the step's product
        in_flight = 0 if self.d_data == 1 else min(self.d_data, 3)
        ring = in_flight * widest * self.block * 4 + max(
            p.scratch_bytes(torch.float32) for p in self.ring_preps)
        return max(combine * self.block * 4, ring)

    def _count_one(self, colors_loc: torch.Tensor) -> torch.Tensor:
        """My shard's walk of one coloring (``(block,)`` colors of my
        vertices) -> the coloring's colorful sum, float64 ``()``, the same
        on every rank of the pod."""
        k = self.k
        leaf_rows = self._my_rows(self.meta[next(
            i for i, nd in enumerate(self.plan.nodes) if nd.is_leaf)
        ].width_pad)
        ks = torch.arange(leaf_rows.start, leaf_rows.stop,
                          dtype=colors_loc.dtype, device=self.device)
        leaf = ((ks[:, None] == colors_loc[None, :])
                & (ks[:, None] < k)).to(torch.float32)
        runner = pexec.PlanExecutor(self.plan, self.exec_schedule)
        root = runner.run(
            leaf, passive_op=lambda p_idx, m_p: self._ring_spmm(m_p),
            combine=self._combine)
        rows = self._my_rows(self.meta[-1].width_pad)
        valid = max(0, min(rows.stop, self.meta[-1].width) - rows.start)
        total = root[:valid].to(torch.float64).sum()
        for axis in ("data", "model"):    # a copy on a one-rank axis
            dist.all_reduce(total, group=self.groups[axis])
        # kept in float32, as CountingEngine's totals are
        return total.to(torch.float32).to(torch.float64)

    def _my_coloring(self, sid) -> torch.Tensor:
        colors = coloring_for_seed(sid, self.n_pad, self.n_true, self.k,
                                   device=self.device)
        return colors.narrow(0, self.my_data * self.block, self.block)

    def _pod_rounds(self, seed_mat: list[list[int]]) -> list[list[float]]:
        """``(rounds, n_pods)`` stream ids -> their sums, each pod running
        its column, then one all-gather over ``pod``."""
        mine = torch.stack([
            self._count_one(self._my_coloring(row[self.my_pod]))
            for row in seed_mat])
        if self.n_pods == 1:
            return [[v] for v in mine.cpu().tolist()]
        out = torch.empty(self.n_pods * len(seed_mat), dtype=torch.float64,
                          device=self.device)
        dist.all_gather_into_tensor(out, mine, group=self.groups["pod"])
        return out.reshape(self.n_pods, -1).t().cpu().tolist()

    # ------------------------------------------------------------------ api
    def count_step_fn(self):
        """-> ``(step, (seed,))``: ``step(seed)`` is my pod's walk of one
        coloring, ``_count_one`` after ``_my_coloring``, the counterpart of
        the reference's ``count_step_fn`` that the dry run traces. ``seed``
        is a 0-d int64 stream id on the device (my pod's, ``my_pod``);
        the result is the coloring's colorful sum, a float64 ``()`` on the
        device. Nothing is read on the host, so the walk traces on fake
        tensors; every rank calls it, as every rank calls ``count_step``."""
        seed = torch.tensor(self.my_pod, dtype=torch.int64,
                            device=self.device)
        return self._count_seed, (seed,)

    def _count_seed(self, seed: torch.Tensor) -> torch.Tensor:
        return self._count_one(self._my_coloring(seed))

    def count_step(self, seeds) -> list[float]:
        """One coloring per pod: ``seeds`` are the ``n_pods`` stream ids
        (int32), the result their colorful sums, the same on every rank
        (the host-side counterpart of :meth:`count_step_fn`)."""
        seeds = [_int32(s) for s in seeds]
        if len(seeds) != self.n_pods:
            raise ValueError(f"{len(seeds)} seeds for {self.n_pods} pods")
        return self._pod_rounds([seeds])[0]

    def count_iterations(self, iterations: list[int],
                         seed: int = 0) -> tuple[float, dict]:
        """Sum of colorful counts over explicit iteration ids, and ``{id:
        sum}`` (for the fault-tolerant runner).

        Iterations go ``n_pods`` at a time (:func:`pod_rounds`). Per-
        iteration values do not depend on the grouping or the mesh, so a
        run resumed on another mesh reproduces a straight one.
        """
        iterations = list(iterations)
        if not iterations:
            return 0.0, {}
        rounds = pod_rounds(iterations, self.n_pods)
        sums = self._pod_rounds([[_stream_id(seed, it) for it in row]
                                 for row in rounds])
        per_iter = {}
        for row, vals in zip(rounds, sums):
            for it, v in zip(row, vals):
                per_iter[it] = float(v)
        return float(sum(per_iter[it] for it in iterations)), per_iter
