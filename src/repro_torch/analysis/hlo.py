"""What rank 0 runs in one traced step: flops, bytes, collectives, ops and
memory, on fake tensors over a fake process group.

The counterpart of the JAX package's ``analysis/hlo.py``, which parses
the optimized (SPMD-partitioned, per-device) HLO text of a compiled step.
The port has no HLO: :func:`trace_step` runs the step once eagerly under
a ``FakeTensorMode`` (shapes and dtypes, nothing allocated, no card) and
a dispatch mode that logs every op rank 0 runs into a :class:`StepTrace`.

**Per-rank counting.** Under DTensor every op is seen twice: once on the
DTensors, at their *global* shapes (what ``FlopCounterMode`` and
``CommDebugMode`` count), then as the local op DTensor's dispatcher runs
on each ``_local_tensor``, with the redistributions it needs as
collectives on local tensors. The logging mode passes the DTensor-level
op on (returns ``NotImplemented``) and logs only the local ones, so a
matmul row-sharded four ways counts a quarter of its global flops, as
the reference's per-device HLO does. The global-shape run that DTensor's
sharding propagation makes to learn an output's shape, and the index
math of its redistribution planning, are not logged; a strided shard's
sizes, offsets and splits run in closed form and the planner's search
memoized (:func:`_bookkeeping_paused`), with DTensor's own results, so a
trace's cost does not grow with a sharded dim. An op DTensor has no
sharding strategy for runs whole on every rank: its inputs gathered, as
XLA's partitioner replicates what it cannot split.

**Conventions** (the reference's, ``src/repro/analysis/hlo.py``):

- flops: torch's ``flop_counter`` formulas (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, attention) and the two counting kernels' own
  (``repro_torch::spmm_gather``: 2 an edge a table row;
  ``repro_torch::ema``: 2 a vertex, output row and split), so a step of
  plain tensors counts what ``FlopCounterMode`` counts.
- bytes accessed: every logged op that is a kernel (not a view, a
  metadata query or an allocation) adds its inputs' and outputs' bytes,
  the same rule for every op.
- collectives, by the reference's five kinds, bytes of the *result*: an
  all-reduce its tensor, an all-gather its gathered size, a
  reduce-scatter its result times the group size (its input), an
  all-to-all its output, and a ring's send/receive pair, counted once at
  the receive as ``collective-permute``, its received buffer.
- ops (:func:`count_ops`): ``dot`` is ``aten.mm``/``bmm``/``addmm``/
  ``baddbmm``; ``convolution`` is ``aten.convolution``; ``custom-call``
  is a ``repro_torch::`` op (a hand-written kernel); ``fusion`` is every
  other kernel, since each eager op is a kernel of its own.
- memory: the live bytes of rank 0's storages (each counted once, views
  share it), from the step's arguments (``arguments=``) on; its peak less
  the arguments is the step's temporary bytes.

**Where eager torch cannot follow.** DTensor refuses what XLA's
partitioner reshards, and the trace reshards there too, the
redistributions logged: a view that splits a dim held split over a mesh
dim the new shape does not divide is retried with the dims it changes
made whole; an op with no sharding strategy (``index_add_``), an
in-place op DTensor cannot place (a ``scatter_`` along a split dim), or
one whose sharding propagation some torch refuses (``_MAY_REFUSE``),
runs on every rank on gathered inputs (:attr:`StepTrace.whole` counts
them). The scatters the models run on split edges, tokens or vocab have
sharding rules of their own (``train/op_sharding``).
A kernel op's fake implementation names the scratch its CUDA path holds
(:func:`note_scratch`). Without a CUDA build of torch (a CPU wheel) a
fake CUDA tensor still computes, but ``Tensor.__getitem__`` /
``__setitem__`` and autograd need the CUDA device guard, which such a
build lacks: :func:`trace_step` then indexes fake CUDA tensors through
aten ops (the ops torch's own indexing runs), and a caller tracing
autograd traces on fake CPU tensors (:func:`trace_device`). Where
DTensor picks its strategies differently (another torch version, another
device: a CPU group has no all-to-all), a DTensor step's counts differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import time
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

__all__ = ["StepTrace", "OpRecord", "trace_step", "trace_device", "collective_summary", "collective_bytes",
           "count_ops", "tensor_bytes", "note_scratch", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d and functional-collective op names -> (kind, which tensors carry
# the reference's bytes: "args0", "args1" or "out")
_COLLECTIVES = {
    "allreduce_": ("all-reduce", "args0"),
    "allreduce_coalesced_": ("all-reduce", "args0"),
    "all_reduce": ("all-reduce", "args0"),
    "all_reduce_": ("all-reduce", "args0"),
    "all_reduce_coalesced": ("all-reduce", "args0"),
    "_allgather_base_": ("all-gather", "args0"),
    "allgather_": ("all-gather", "args0"),
    "allgather_into_tensor_coalesced_": ("all-gather", "args0"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_reduce_scatter_base_": ("reduce-scatter", "args1"),
    "reduce_scatter_": ("reduce-scatter", "args1"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "args1"),
    "reduce_scatter_tensor": ("reduce-scatter", "args0"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "args0"),
    "alltoall_base_": ("all-to-all", "args0"),
    "alltoall_": ("all-to-all", "args0"),
    "all_to_all_single": ("all-to-all", "out"),
    "recv_": ("collective-permute", "args0"),
}
_COMM_NAMESPACES = ("c10d", "_c10d_functional")
_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_VIEW_OPS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default}
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty",
          "new_empty_strided", "empty_permuted"}
# views whose schemas carry no alias annotation
_VIEWS = {"_unsafe_view", "lift_fresh"}
# shape and layout queries (FlopCounterMode's own list), never kernels
_META_OPS = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default,
}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree (a DTensor's local shard)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


@dataclasses.dataclass
class OpRecord:
    """One op rank 0 ran: its name (``namespace::name.overload``), its
    kind (``dot``, ``convolution``, ``custom-call``, ``fusion``, a
    collective kind, ``view`` or ``alloc``), flops, bytes accessed and,
    for a collective, the reference's bytes."""

    name: str
    kind: str
    flops: int = 0
    bytes: int = 0
    collective_bytes: int = 0


@dataclasses.dataclass
class StepTrace:
    """Rank 0's op log of one traced step and its memory: the bytes of
    the arguments, of the outputs, and the peak of live storage; the ops
    that ran whole for want of a DTensor strategy; and the largest real
    (not fake, not meta) tensor DTensor's unlogged bookkeeping made."""

    ops: list = dataclasses.field(default_factory=list)
    # ops DTensor has no strategy for, run whole: {name: times}
    whole: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    bookkeeping_bytes: int = 0
    seconds: float = 0.0

    @property
    def flops(self) -> int:
        return sum(r.flops for r in self.ops)

    @property
    def bytes_accessed(self) -> int:
        return sum(r.bytes for r in self.ops)

    @property
    def temp_bytes(self) -> int:
        """The peak of live storage less the arguments."""
        return self.peak_bytes - self.argument_bytes


def collective_summary(trace: StepTrace) -> dict[str, dict]:
    """``{kind: {"count", "bytes"}}`` of the trace's collectives, by the
    reference's kinds and result-shape bytes (module docstring); kinds
    that never ran are left out, as the reference leaves them out."""
    out: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for r in trace.ops:
        if r.kind in COLLECTIVE_KINDS:
            out[r.kind]["count"] += 1
            out[r.kind]["bytes"] += r.collective_bytes
    return dict(out)


def collective_bytes(trace: StepTrace) -> int:
    return sum(v["bytes"] for v in collective_summary(trace).values())


def count_ops(trace: StepTrace, names=("fusion", "custom-call",
                                       "convolution", "dot")
              ) -> dict[str, int]:
    """Kernels of each kind: ``dot`` = ``aten.mm``/``bmm``/``addmm``/
    ``baddbmm``, ``convolution`` = ``aten.convolution``, ``custom-call``
    = a ``repro_torch::`` op, ``fusion`` = every other kernel (each eager
    op is a kernel of its own, where XLA fuses several into one)."""
    counts = {n: 0 for n in names}
    for r in trace.ops:
        if r.kind in counts:
            counts[r.kind] += 1
    return counts


# ------------------------------------------------------------ the tracer
@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` has a composite (decomposing) kernel: the test
    ``OpOverload.decompose`` makes, once an op."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


@functools.lru_cache(maxsize=None)
def _kind(func) -> str:
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns in _COMM_NAMESPACES:
        return _COLLECTIVES.get(name, ("comm", None))[0]
    if ns == "repro_torch":
        return "custom-call"
    if name in _ALLOC:
        return "alloc"
    rets = func._schema.returns
    if name in _VIEWS or rets and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in rets):
        return "view"
    if name in _DOTS:
        return "dot"
    if name == "convolution":
        return "convolution"
    return "fusion"


# the live storages of the trace in progress (one at a time)
_TRACING: list = []


def note_scratch(*tensors) -> None:
    """An op's fake implementation names the tensors its CUDA path holds
    while it runs (its output and scratch): a traced step's peak sees
    them beside what is live. Outside a trace it does nothing."""
    if _TRACING:
        st = _TRACING[-1]
        st.peak = max(st.peak, st.now + tensor_bytes(tensors))


class _Storages:
    """Live bytes of the storages registered so far, each once, and
    their peak; a storage leaves when torch frees it."""

    def __init__(self):
        self.live: dict[int, int] = {}
        self.refs: dict[int, weakref.ref] = {}
        self.now = 0
        self.peak = 0

    def add(self, tree) -> None:
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self.live:
                continue
            nbytes = st.nbytes()
            self.live[key] = nbytes
            self.refs[key] = weakref.ref(st, lambda _, k=key: self._drop(k))
            self.now += nbytes
            self.peak = max(self.peak, self.now)

    def _drop(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)
        self.refs.pop(key, None)


class _RankZero(TorchDispatchMode):
    """Logs rank 0's local ops into a :class:`StepTrace`."""

    def __init__(self, trace: StepTrace, storages: _Storages):
        super().__init__()
        self.trace = trace
        self.storages = storages
        self.paused = 0
        self.passing = None
        self.in_whole = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return NotImplemented
        leaves = tree_leaves((args, kwargs))
        if any(_is_dtensor(a) for a in leaves):
            if self.passing is func:       # _redispatch's own call
                self.passing = None
                return NotImplemented
            if self.paused or self.in_whole:
                return NotImplemented
            if func in _VIEW_OPS:
                return self._view(func, args, kwargs)
            if not _has_strategy(func):
                return self._whole(func, args, kwargs)
            if _mutates_first(func):
                return self._in_place(func, args, kwargs)
            if func in _MAY_REFUSE:
                return self._split_or_whole(func, args, kwargs)
            # DTensor's dispatcher runs the local ops (and the
            # redistributions) under this mode: log those instead
            return NotImplemented
        if self.paused:
            out = func(*args, **kwargs)
            real = [t.numel() * t.element_size() for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor) and not t.is_meta
                    and not isinstance(t, FakeTensor)]
            self.trace.bookkeeping_bytes = max([self.trace.bookkeeping_bytes,
                                                *real])
            return out
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default \
                and _composite(func):
            # FlopCounterMode's rule: count a composite op by its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if func is torch.ops.prim.device.default:
            return out
        kind = _kind(func)
        rec = OpRecord(f"{func.namespace}::{func._schema.name.split('::')[-1]}"
                       f".{func._overloadname}", kind)
        if packet in flop_registry:
            rec.flops = int(flop_registry[packet](*args, **kwargs,
                                                  out_val=out))
        if kind not in ("view", "alloc", "comm"):
            rec.bytes = tensor_bytes((args, kwargs)) + tensor_bytes(out)
        if kind in COLLECTIVE_KINDS:
            where = _COLLECTIVES[func._schema.name.split("::")[-1]][1]
            rec.collective_bytes = tensor_bytes(
                out if where == "out" else args[int(where[-1])])
        self.trace.ops.append(rec)
        self.storages.add(out)
        return out

    def _redispatch(self, func, args, kwargs):
        """``func`` on DTensors through DTensor's own dispatch, under this
        mode (its local ops logged)."""
        self.passing = func
        try:
            with self:
                return func(*args, **kwargs)
        finally:
            self.passing = None

    def _view(self, func, args, kwargs):
        """A view DTensor refuses, or gets wrong, is retried with the dims
        it changes made whole (an all-gather, logged), as XLA reshards
        there: one that splits or merges a dim held split over a mesh dim
        the new shape does not divide (``(H, Dh) -> (Hkv, G, Dh)`` with 32
        heads on 16 ranks and 8 kv heads, or its gradient's view back),
        or that splits a dim held split over two mesh dims (DTensor's
        local shape then disagrees with its shard). What the failed try
        logged is dropped."""
        logged = len(self.trace.ops)
        try:
            return self._redispatch(func, args, kwargs)
        except RuntimeError:
            del self.trace.ops[logged:]
            with self:
                x = _whole_where_reshaped(args[0], tuple(args[1]))
        return self._redispatch(func, (x,) + tuple(args[1:]), kwargs)

    def _split_or_whole(self, func, args, kwargs):
        """An op of :data:`_MAY_REFUSE` through DTensor, or whole
        (:meth:`_whole`) where DTensor's sharding propagation refuses it.
        What the refused try logged is dropped. Every other op goes to
        DTensor once, unwatched: a second dispatch of each op through this
        mode cost a reduced nequip trace an eighth of its seconds."""
        logged = len(self.trace.ops)
        try:
            return self._redispatch(func, args, kwargs)
        except RuntimeError as e:
            if "Sharding propagation failed" not in str(e):
                raise
            del self.trace.ops[logged:]
        return self._whole(func, args, kwargs)

    def _in_place(self, func, args, kwargs):
        """An in-place op through DTensor, or whole (:meth:`_whole`) where
        DTensor refuses it: one whose strategy would change its target's
        placements (a ``scatter_`` along a split dim), or whose target is
        a plain tensor. What the refused try logged is dropped."""
        logged = len(self.trace.ops)
        try:
            return self._redispatch(func, args, kwargs)
        except (RuntimeError, AssertionError):
            del self.trace.ops[logged:]
        return self._whole(func, args, kwargs)

    def _whole(self, func, args, kwargs):
        """An op DTensor has no sharding strategy for (``index_add_``,
        say) runs whole on every rank, as XLA's partitioner falls back to
        replicating: its DTensor inputs gathered (logged), the op run on
        the whole tensors (logged), its outputs replicated; an in-place
        op's result is put back on its target's placements. The
        redistributions are DTensor's own, on the local tensors, with no
        DTensor op dispatched inside. An in-place ``detach_`` moves no
        data: its DTensor comes back as it is."""
        if func is torch.ops.aten.detach_.default:
            return args[0]
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._dtensor_spec import (DTensorSpec,
                                                            TensorMeta)
        from torch.distributed.tensor._redistribute import \
            redistribute_local_tensor
        mesh = next(a.device_mesh for a in tree_leaves((args, kwargs))
                    if _is_dtensor(a))
        whole = (Replicate(),) * mesh.ndim
        name = f"{func.namespace}::{func._schema.name.split('::')[-1]}"
        self.trace.whole[name] = self.trace.whole.get(name, 0) + 1

        def spec(t, placements):
            return DTensorSpec(mesh, placements, tensor_meta=TensorMeta(
                t.shape, t.stride(), t.dtype))

        def gather(x):
            if not _is_dtensor(x):
                return x
            return redistribute_local_tensor(x._local_tensor, x._spec,
                                             spec(x, whole))
        self.in_whole += 1       # its own DTensor ops go to DTensor
        try:
            with self:
                largs, lkw = tree_map(gather, (args, kwargs))
                out = func(*largs, **lkw)
                target = args[0] if args else None
                if _mutates_first(func):
                    if _is_dtensor(target):
                        target._local_tensor.copy_(redistribute_local_tensor(
                            largs[0], spec(target, whole), target._spec))
                    return target
        finally:
            self.in_whole -= 1
        return tree_map(lambda t: DTensor(t, spec(t, whole),
                                          requires_grad=False)
                        if isinstance(t, torch.Tensor) else t, out)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# ops whose sharding propagation some torch refuses on the grid's
# placements: torch 2.11 an ``index`` of a replicated table by ids split
# over two mesh dims (nequip's species lookup on the multi-pod mesh),
# which 2.13 splits
_MAY_REFUSE = {torch.ops.aten.index.Tensor}


@functools.lru_cache(maxsize=None)
def _has_strategy(func) -> bool:
    """Whether DTensor's dispatcher can take ``func``: a sharding
    strategy or rule, a handler of its own, or a composite kernel it
    decomposes."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prop = disp.sharding_propagator
    tables = (prop.op_strategy_funcs, prop.op_to_rules,
              getattr(prop, "op_single_dim_strategy_funcs", {}),
              getattr(disp, "_custom_op_handlers", {}))
    return any(func in t for t in tables) or _composite(func)


@functools.lru_cache(maxsize=None)
def _mutates_first(func) -> bool:
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None \
        and args[0].alias_info.is_write


@contextlib.contextmanager
def _bookkeeping_paused(mode: _RankZero):
    """Run DTensor's own bookkeeping outside the trace: its sharding
    propagation (with the global-shape run it makes to learn an output's
    shape) and its redistribution planning are not rank 0's step. They
    run unlogged and outside the fake mode.

    Three parts of it are replaced for the trace by what computes the
    same results at a cost that does not grow with the tensors: a strided
    shard's sizes and offsets (:func:`_strided_runs`, where DTensor
    splits a real ``arange`` over the sharded dim into ``split_factor x
    num_chunks`` pieces), a strided shard's split of a fake tensor
    (:func:`_strided_split`, the same ``cat`` a shard without the pieces),
    and the redistribution planner's next states and their costs,
    memoized for each planner (:func:`_memo_next_state`; on a 3-D mesh
    its Dijkstra search otherwise rebuilds them for every pair of specs
    an op's strategies are costed at)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    try:
        from torch.distributed.tensor import _redistribute
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard
    except ImportError:      # torch without DTensor
        yield
        return
    planner = getattr(_redistribute, "DTensorRedistributePlanner", None)
    # (owner, name, its closed form or None, whether it runs paused)
    targets = [(ShardingPropagator, "propagate_op_sharding_non_cached",
                None, True),
               (_redistribute, "_gen_transform_infos_non_cached", None, True),
               (_StridedShard, "local_shard_size_and_offset",
                _closed_size_and_offset, True),
               (_StridedShard, "_split_tensor", _strided_split, False),
               (planner, "get_next_state", _memo_next_state, False)]
    saved = [(owner, name, inspect.getattr_static(owner, name), closed,
              pause) for owner, name, closed, pause in targets
             if owner is not None and hasattr(owner, name)]

    def paused(fn):
        if isinstance(fn, staticmethod):
            return staticmethod(paused(fn.__func__))

        def run(*args, **kwargs):
            mode.paused += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                mode.paused -= 1
        return run
    for owner, name, fn, closed, pause in saved:
        fn = closed(fn) if closed is not None else fn
        setattr(owner, name, paused(fn) if pause else fn)
    try:
        yield
    finally:
        for owner, name, fn, _, _ in saved:
            setattr(owner, name, fn)


# ------------------------------------ DTensor's bookkeeping in closed form
def _strided_runs(split_factor: int, size: int, num_chunks: int,
                  rank: int) -> list[tuple[int, int, int, int]]:
    """Where ``_StridedShard(split_factor)`` puts ``rank``'s shard of a dim
    of ``size`` split ``num_chunks`` ways, as runs ``(first, stride,
    count, length)``: ``count`` runs of ``length`` indices, the ``j``-th
    starting at ``first + j * stride``. DTensor's own layout (its
    ``_split_tensor`` of an ``arange``): ``torch.chunk`` into
    ``split_factor`` pieces (``q = ceil(size / split_factor)`` each, the
    last ones shorter or empty), each piece chunked ``num_chunks`` ways,
    shard ``rank`` the ``rank``-th chunk of every piece in order. The
    full pieces give one run a piece, the short one at most one more."""
    q = -(-size // split_factor)
    full = size // q if q else 0
    runs = []
    for piece, first, count in ((q, 0, full), (size - full * q, full * q, 1)):
        if not (piece and count):
            continue
        s = -(-piece // num_chunks)
        length = min(s, piece - rank * s)
        if length > 0:
            runs.append((first + rank * s, q, count, length))
    return runs


def _closed_size_and_offset(fn):
    """``_StridedShard.local_shard_size_and_offset`` by
    :func:`_strided_runs`: the shard's size and its first offset (``-1``
    when it is empty), every offset, or none, as the caller asks (torch
    2.13: ``offset_mode`` FIRST / ALL / NONE; torch 2.11:
    ``return_first_offset``). Symbolic sizes go to DTensor's own ``fn``."""
    import numpy as np

    def local_shard_size_and_offset(self, curr_local_size, num_chunks, rank,
                                    *args, **kwargs):
        sf = self.split_factor
        if not all(type(v) is int
                   for v in (sf, curr_local_size, num_chunks, rank)):
            return fn(self, curr_local_size, num_chunks, rank, *args,
                      **kwargs)
        (how,) = args or tuple(kwargs.values()) or (True,)
        if not isinstance(how, bool):           # torch 2.13's enum
            how = {0: True, 1: False}.get(int(how))
        runs = _strided_runs(sf, curr_local_size, num_chunks, rank)
        size = sum(count * length for _, _, count, length in runs)
        if how is None:
            return size, None
        if how:
            return size, runs[0][0] if runs else -1
        offsets = [(first + stride * np.arange(count)[:, None]
                    + np.arange(length)).ravel()
                   for first, stride, count, length in runs]
        return size, np.concatenate(offsets).tolist() if offsets else []
    return local_shard_size_and_offset


def _strided_split(fn):
    """``_StridedShard._split_tensor`` by :func:`_strided_runs`: shard
    ``i`` is one ``cat`` of its runs' strided views, the one kernel
    DTensor's loop runs for it (the same bytes), without the loop's
    ``split_factor x num_chunks`` chunk views and the zero-byte fills of
    its empty chunks (no kernel on a card). A split whose full and short
    pieces leave a shard runs of two lengths goes to DTensor's ``fn``."""
    def _split_tensor(self, tensor, num_chunks, *, with_padding=True,
                      contiguous=True):
        sf, dim = self.split_factor, self.dim
        size = tensor.size(dim) if dim < tensor.dim() else 0
        layouts = [_strided_runs(sf, size, num_chunks, i)
                   for i in range(num_chunks)] \
            if type(sf) is int and type(size) is int and size else None
        if layouts is None or any(len({r[3] for r in runs}) > 1
                                  for runs in layouts):
            return fn(self, tensor, num_chunks, with_padding=with_padding,
                      contiguous=contiguous)
        shape, stride = tuple(tensor.shape), tuple(tensor.stride())

        def run(first, step, count, length):
            return tensor.as_strided(
                shape[:dim] + (count, length) + shape[dim + 1:],
                stride[:dim] + (step * stride[dim], stride[dim])
                + stride[dim + 1:],
                tensor.storage_offset() + first * stride[dim])
        shards = [torch.cat([run(*r) for r in runs], dim).flatten(dim, dim + 1)
                  if runs else torch.cat([tensor.narrow(dim, 0, 0)], dim)
                  for runs in layouts]
        if not with_padding:
            return shards, []
        most = max(t.size(dim) for t in shards)
        return shards, [most - t.size(dim) for t in shards]
    return _split_tensor


def _memo_next_state(fn):
    """The planner's ``get_next_state``, memoized for each planner (one a
    mesh and tensor meta) by the state and the target sets it reads, in
    their order (strided shards and partial reductions named by the
    targets so far): the same states and costs in the same order, each
    computed once."""
    memo = weakref.WeakKeyDictionary()

    def get_next_state(self, placements, tensor_mesh_dim_tuple):
        key = (placements, tensor_mesh_dim_tuple,
               tuple(getattr(self, "strided_shard_placements_in_target", ())),
               tuple(getattr(self, "partial_reduce_ops_in_target", ())))
        seen = memo.setdefault(self, {})
        if key not in seen:
            seen[key] = fn(self, placements, tensor_mesh_dim_tuple)
        return seen[key]
    return get_next_state


# ------------------------------------------ where eager torch cannot follow
class _AtenIndexing(TorchFunctionMode):
    """Without a CUDA build of torch, ``Tensor.__getitem__`` and
    ``__setitem__`` of a fake CUDA tensor go through aten ops
    (``select``, ``slice``, ``unsqueeze``, ``index``, ``index_put_``), in
    the order torch's C++ indexing applies them: that path takes the CUDA
    device guard, which a CPU build lacks."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__) \
                and args[0].device.type == "cuda":
            return _aten_item(func, *args)
        return func(*args, **kwargs)


def _whole_where_reshaped(x, size):
    """``x`` (a DTensor) with every mesh dim that splits a tensor dim the
    view to ``size`` changes made whole (``Replicate``); the dims before
    the first change and after the last keep their placements. DTensor's
    own redistribution, on the local tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import \
        redistribute_local_tensor
    old = tuple(x.shape)
    new = tuple(torch.empty(old, device="meta").view(size).shape)
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while hi < min(len(old), len(new)) - lo and old[-1 - hi] == new[-1 - hi]:
        hi += 1
    changed = range(lo, len(old) - hi)
    placements = tuple(
        Replicate() if p.is_shard() and getattr(p, "dim", None) in changed
        else p for p in x.placements)
    target = DTensorSpec(x.device_mesh, placements,
                         tensor_meta=x._spec.tensor_meta)
    local = redistribute_local_tensor(x._local_tensor, x._spec, target)
    return DTensor(local, target, requires_grad=False)


def _aten_item(func, x, index, value=None):
    """``x[index]`` or ``x[index] = value`` through aten ops."""
    view, tensors = _basic_index(x, index)
    if func is torch.Tensor.__getitem__:
        return torch.ops.aten.index.Tensor(view, tensors) if tensors \
            else view
    if tensors:
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(value, dtype=view.dtype, device=view.device)
        torch.ops.aten.index_put_(view, tensors, value)
    elif isinstance(value, torch.Tensor):
        view.copy_(value)
    else:
        view.fill_(value)
    return None


def _basic_index(x: torch.Tensor, index):
    """``x`` after the index's ints, slices, ``None`` and ``...`` -> (the
    view, the tensor indices by dim of the view, ``None`` in between; an
    empty list when there is none)."""
    if not isinstance(index, tuple):
        index = (index,)
    index = tuple(torch.tensor(i, device=x.device)
                  if isinstance(i, list) else i for i in index)
    # the dims the index names; an Ellipsis covers the others
    named = sum(1 for i in index if i is not None and i is not Ellipsis)
    ndim, dim, tensors = x.dim(), 0, {}
    for i in index:
        if i is Ellipsis:
            dim += ndim - named
            continue
        if i is None:
            x = x.unsqueeze(dim)
            dim += 1
        elif isinstance(i, bool):
            raise NotImplementedError("bool indices of a fake CUDA tensor")
        elif isinstance(i, int):
            x = x.select(dim, i)
        elif isinstance(i, slice):
            step = 1 if i.step is None else i.step
            x = torch.ops.aten.slice.Tensor(x, dim, i.start, i.stop, step)
            dim += 1
        elif isinstance(i, torch.Tensor):
            if i.dtype == torch.bool:
                raise NotImplementedError("mask indices of a fake tensor: "
                                          "their shape depends on the data")
            tensors[dim] = i
            dim += 1
        else:
            raise TypeError(f"index {i!r} of a fake CUDA tensor")
    if not tensors:
        return x, []
    return x, [tensors.get(d) for d in range(max(tensors) + 1)]


# ----------------------------------------------------------------- entry
def trace_device(autograd: bool) -> torch.device:
    """The fake tensors' device for a traced step: CUDA, unless torch is
    a CPU build and the step runs autograd (module docstring)."""
    if autograd and not torch.backends.cuda.is_built():
        return torch.device("cpu")
    return torch.device("cuda", 0)


def trace_step(fn, *args, arguments=None, mode: FakeTensorMode | None = None,
               **kwargs):
    """Run ``fn(*args, **kwargs)`` once inside ``mode`` (a
    ``FakeTensorMode``; the arguments must already be its fake tensors or
    DTensors of them) and log what rank 0 runs -> (``fn``'s result, the
    :class:`StepTrace`). ``arguments`` is the tree whose bytes are the
    step's arguments (default ``(args, kwargs)``)."""
    trace = StepTrace()
    storages = _Storages()
    if arguments is None:
        arguments = (args, kwargs)
    storages.add(arguments)
    trace.argument_bytes = storages.now
    rank0 = _RankZero(trace, storages)
    t0 = time.perf_counter()
    _TRACING.append(storages)
    with contextlib.ExitStack() as stack:
        stack.callback(_TRACING.pop)
        if mode is not None:
            stack.enter_context(mode)
        if not torch.backends.cuda.is_built():
            stack.enter_context(_AtenIndexing())
        stack.enter_context(_bookkeeping_paused(rank0))
        stack.enter_context(rank0)
        out = fn(*args, **kwargs)
    trace.seconds = time.perf_counter() - t0
    trace.peak_bytes = storages.peak
    trace.output_bytes = _unique_bytes(out)
    return out, trace


def _unique_bytes(tree) -> int:
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total
