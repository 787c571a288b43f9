"""SpMM ``Y = M @ A``: the CUDA kernels' wrappers and their plain versions,
over two operands.

``prepare(graph, "bsr")`` lifts the adjacency into the destination-sorted
stream of dense 128x128 {0,1} blocks (``Graph.bsr``) on a device, plus the
per-destination-tile run pointer ``tile_ptr`` the CUDA kernels walk and
each block's nonzeros by destination column (``col_ptr``, ``nz_src``:
``structure.block_nonzero_index``). The BSR SpMM and the fused kernel
walk only those nonzeros; the shared-passive group kernel still
multiplies the dense blocks.
``prepare(graph, "gather")`` puts the destination-sorted edge stream
(``Graph.gather_layout``) there instead, with its hubs' segments: no
blocks, so it fits graphs whose dense blocks would not (a social graph's
edges scatter over millions of tile pairs). The gather kernel reads the
table through a vertex-major scratch of ``128 / itemsize`` rows, allocated
per call (:meth:`GatherPrep.scratch_bytes`). ``spmm(m, prep)`` applies
``Y = M @ A`` to a ``(..., C, N)``
table with the leading (batch) dimensions folded into rows — one launch
for a whole coloring batch, as in the JAX package's ``kernels/spmm/ops.py``
— and dispatches on the prep's kind.

On a CPU tensor :func:`spmm` runs the plain version (:func:`spmm_plain`,
:func:`spmm_gather_plain`); on a CUDA tensor it launches
``csrc/spmm_bsr.cu`` or ``csrc/spmm_gather.cu``, or raises.
``spmm.launches`` counts BSR launches, ``spmm_gather.launches`` the
gather wrapper's calls that reach the card (each launches a transpose, a
gather and, with hubs, a hub pass per chunk of rows).

Three more backends are the JAX package's XLA ones, with no Pallas kernel
behind them, so torch's own ops serve on either device
(:class:`OpsPrep`): ``"segment"`` gathers the destination-sorted edge
stream's source columns and sums each destination's run with
``torch.segment_reduce`` (a fixed order, no atomics); ``"ell"`` adds the
padded neighbor table's columns in order; ``"dense"`` multiplies by the
dense adjacency (tiny graphs and the oracle). Sums of sub-f32 tables run
in the accumulator dtype, as the kernels' do.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.device import accum_dtype, card_dtype_code, resolve_device
from repro_torch.graph.structure import Graph, block_nonzero_index
from repro_torch.kernels import _build

__all__ = ["BsrPrep", "GatherPrep", "OpsPrep", "METHODS", "prepare",
           "from_arrays", "spmm", "spmm_plain", "spmm_ops", "ell_sweep",
           "spmm_gather",
           "spmm_gather_plain", "spmm_row_chunk"]

# operand kinds of prepare(): the JAX package's "pallas_bsr" and
# "pallas_gather" backends, then its XLA ones
METHODS = ("bsr", "gather", "segment", "ell", "dense")
# the backends torch's own ops run (OpsPrep)
OPS_METHODS = ("segment", "ell", "dense")

# elements of the plain version's gathered (rows, blocks, tile) operand per
# chunk: bounds its working memory at full graph size
_PLAIN_CHUNK_ELEMS = 1 << 27
# elements of the segment backend's gathered (edges, rows) block per chunk
# of rows (the reference's _SEGMENT_TARGET_ELEMS)
_SEGMENT_TARGET_ELEMS = 1 << 24
# block edge the CUDA kernels are compiled for (TILE in csrc/bsr_tile.cuh)
_KERNEL_TILE = 128
# bytes of one vertex's slice of the gather kernel's scratch (LINE in
# csrc/spmm_gather.cu): 32 rows of f32, 64 of bf16 per chunk
_GATHER_LINE = 128
# a gather destination of more edges than this is summed by segments of
# this many edges, one octet's work each, so no run is the launch's tail
# (tools/spmm_compare.py --hub-sweep; its readings on rmat(20) in PERF.md)
HUB_DEGREE = 128


@dataclasses.dataclass
class BsrPrep:
    """The BSR adjacency on one device (shared by the SpMM and fused
    kernels). Block ``b`` is ``A[src_tile[b] tile, dst_tile[b] tile]``;
    destination tile ``t`` owns blocks ``tile_ptr[t]:tile_ptr[t+1]``."""

    n: int
    blocks: torch.Tensor    # (n_blocks, tile, tile) storage dtype, {0, 1}
    src_tile: torch.Tensor  # (n_blocks,) int32
    dst_tile: torch.Tensor  # (n_blocks,) int32, ascending
    tile_ptr: torch.Tensor  # (n_tiles + 1,) int32
    tile: int
    n_tiles: int
    # block b's column c sums source rows nz_src[col_ptr[b, c]:col_ptr[b,
    # c + 1]] of its source tile (structure.block_nonzero_index)
    col_ptr: torch.Tensor   # (n_blocks, tile + 1) int32
    nz_src: torch.Tensor    # (nnz,) uint8

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def index_bytes(self) -> int:
        """Bytes of the nonzero index the BSR SpMM and fused kernels
        walk."""
        return (self.col_ptr.numel() * self.col_ptr.element_size()
                + self.nz_src.numel())


@dataclasses.dataclass
class GatherPrep:
    """The destination-sorted edge stream on one device: destination v
    sums the table columns ``src[row_ptr[v]:row_ptr[v+1]]``; destination
    tile t owns edges ``tile_ptr[t]:tile_ptr[t+1]``.

    A hub, a destination of more than ``hub_degree`` edges, is summed by
    segments: hub ``h`` is vertex ``hub_vertex[h]``, its run cut into
    segments ``hub_seg_ptr[h]:hub_seg_ptr[h+1]`` of ``hub_degree`` edges
    (the last one shorter), segment ``j`` the edges ``seg[j, 0]:seg[j,
    1]``, in stream order; the kernel adds a hub's segments in that order."""

    n: int
    src: torch.Tensor          # (m,) int32
    row_ptr: torch.Tensor      # (n + 1,) int64
    tile_ptr: torch.Tensor     # (n_tiles + 1,) int64
    tile: int
    hub_degree: int
    hub_vertex: torch.Tensor   # (n_hubs,) int32, ascending
    hub_seg_ptr: torch.Tensor  # (n_hubs + 1,) int32
    seg: torch.Tensor          # (n_segments, 2) int64, [first, end) edge

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_hubs(self) -> int:
        return int(self.hub_vertex.numel())

    @property
    def n_segments(self) -> int:
        return int(self.seg.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the edge stream, its pointers and the hub segments."""
        return sum(t.numel() * t.element_size()
                   for t in (self.src, self.row_ptr, self.tile_ptr,
                             self.hub_vertex, self.hub_seg_ptr, self.seg))

    def scratch_bytes(self, dtype: torch.dtype) -> int:
        """Device bytes one kernel call allocates besides its output: the
        vertex-major ``(n, 128 / itemsize)`` chunk of the table in
        ``dtype`` and the hub segments' f32 partial sums."""
        chunk = _GATHER_LINE // dtype.itemsize
        return self.n * _GATHER_LINE + self.n_segments * chunk * 4


@dataclasses.dataclass
class OpsPrep:
    """The operand of a backend torch's own ops run (``OPS_METHODS``):
    ``"segment"``: ``src`` (m,) sorted by destination and ``degrees`` (n,),
    the run lengths; ``"ell"``: ``nbr`` (max_deg, n) neighbor ids by
    column and ``mask`` (max_deg, n) in the storage dtype; ``"dense"``:
    ``a`` (n, n) in the storage dtype."""

    method: str
    n: int
    arrays: dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device


def from_arrays(n: int, blocks, src_tile, dst_tile, *,
                dtype=torch.float32, device=None) -> BsrPrep:
    """A prep from the block stream as arrays (numpy or torch); builds the
    run pointer from the sorted ``dst_tile`` and the nonzero index from
    the blocks' nonzeros. ``device=None`` is CUDA."""
    blocks = torch.as_tensor(blocks)
    nz = [t.cpu().numpy() for t in torch.nonzero(blocks, as_tuple=True)]
    col_ptr, nz_src = block_nonzero_index(
        int(blocks.shape[0]), int(blocks.shape[-1]), *nz)
    return _bsr_prep(n, blocks, src_tile, dst_tile, col_ptr, nz_src,
                     dtype=dtype, device=resolve_device(device))


def _bsr_prep(n, blocks, src_tile, dst_tile, col_ptr, nz_src, *, dtype,
              device) -> BsrPrep:
    dst_np = np.array(dst_tile, np.int32)     # a writable copy for torch
    if np.any(np.diff(dst_np) < 0):
        raise ValueError("dst_tile must be sorted ascending")
    tile = int(blocks.shape[-1])
    n_tiles = -(-n // tile)
    tile_ptr = np.searchsorted(dst_np, np.arange(n_tiles + 1)).astype(np.int32)
    if np.any(np.diff(tile_ptr) == 0):
        raise ValueError("every destination tile needs at least one block")
    return BsrPrep(
        n=n, blocks=blocks.to(device=device, dtype=dtype),
        src_tile=torch.as_tensor(np.array(src_tile, np.int32),
                                 device=device),
        dst_tile=torch.as_tensor(dst_np, device=device),
        tile_ptr=torch.as_tensor(tile_ptr, device=device),
        tile=tile, n_tiles=n_tiles,
        col_ptr=torch.as_tensor(col_ptr, device=device),
        nz_src=torch.as_tensor(nz_src, device=device))


def prepare(g: Graph, method: str = "bsr", *, dtype=torch.float32,
            device=None, tile: int = 128) -> BsrPrep | GatherPrep:
    """The SpMM operand of ``g`` on ``device`` (``None`` is CUDA).

    ``"bsr"``: the dense blocks in storage dtype ``dtype``, densified where
    they live from the edges' slots, so the host never holds the dense
    stream, and their nonzero index, built on the host. ``"gather"``: the
    edge stream, its run pointers and the segments of its hubs (vertices
    of more than ``HUB_DEGREE`` edges). It holds no values, so ``dtype``
    does not enter. ``"segment"``, ``"ell"`` and ``"dense"``: the edge
    stream, the padded neighbor table (``Graph.ell``) or the dense
    adjacency (:class:`OpsPrep`)."""
    if method not in METHODS:
        raise ValueError(f"unknown SpMM operand {method!r}; "
                         f"choose from {METHODS}")
    device = resolve_device(device)
    if method == "gather":
        return _gather_prep(g, device, tile)
    if method in OPS_METHODS:
        return _ops_prep(g, method, dtype, device)
    lay = g.padded(tile).bsr_layout(tile)
    blocks = torch.zeros((lay.n_blocks, tile, tile), dtype=dtype,
                         device=device)
    idx = [torch.as_tensor(a, device=device)
           for a in (lay.edge_block, lay.edge_src, lay.edge_dst)]
    blocks[idx[0], idx[1], idx[2]] = 1
    index = block_nonzero_index(lay.n_blocks, tile, lay.edge_block,
                                lay.edge_src, lay.edge_dst)
    return _bsr_prep(g.n, blocks, lay.src_tile, lay.dst_tile, *index,
                     dtype=dtype, device=device)


def _gather_prep(g: Graph, device, tile: int = 128,
                 hub_degree: int = HUB_DEGREE) -> GatherPrep:
    """:func:`prepare`'s gather operand, its hubs cut at ``hub_degree``
    edges (``g.n`` cuts none)."""
    if hub_degree < 1:
        raise ValueError(f"hub_degree must be positive, got {hub_degree}")
    lay = g.gather_layout(tile)
    row_ptr = lay.row_ptr
    deg = np.diff(row_ptr)
    hubs = np.flatnonzero(deg > hub_degree)
    n_seg = -(-deg[hubs] // hub_degree)
    seg_ptr = np.concatenate([[0], np.cumsum(n_seg)]).astype(np.int64)
    if seg_ptr[-1] >= 1 << 31:
        raise ValueError("too many hub segments for int32 pointers")
    owner = np.repeat(hubs, n_seg)
    first = row_ptr[owner] + hub_degree * (
        np.arange(seg_ptr[-1]) - np.repeat(seg_ptr[:-1], n_seg))
    end = np.minimum(first + hub_degree, row_ptr[owner + 1])
    return GatherPrep(
        n=g.n, src=torch.as_tensor(lay.src, device=device),
        row_ptr=torch.as_tensor(row_ptr, device=device),
        tile_ptr=torch.as_tensor(lay.tile_ptr, device=device), tile=tile,
        hub_degree=hub_degree,
        hub_vertex=torch.as_tensor(hubs.astype(np.int32), device=device),
        hub_seg_ptr=torch.as_tensor(seg_ptr.astype(np.int32), device=device),
        seg=torch.as_tensor(np.stack([first, end], axis=1), device=device))


def _ops_prep(g: Graph, method: str, dtype, device) -> OpsPrep:
    if method == "segment":
        src, _ = g.edges_by_dst
        arrays = {"src": torch.as_tensor(src, dtype=torch.int64),
                  "degrees": torch.as_tensor(g.degrees)}
    elif method == "ell":
        nbr, mask = g.ell()
        arrays = {"nbr": torch.as_tensor(nbr.T, dtype=torch.int64),
                  "mask": torch.as_tensor(mask.T).to(dtype)}
    else:
        arrays = {"a": torch.as_tensor(g.to_dense()).to(dtype)}
    return OpsPrep(method, g.n, {k: v.contiguous().to(device)
                                 for k, v in arrays.items()})


def ell_sweep(m: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
              axis: int, acc: torch.Tensor | None = None,
              buf: torch.Tensor | None = None) -> torch.Tensor:
    """``sum_d index_select(m, axis, nbr[d]) * mask[d]``, column d after d,
    in the accumulator dtype: the ``"ell"`` backend's sum and the
    row-major engines' neighbor sweep. ``nbr`` is ``(max_deg, N)``;
    ``mask[d]`` broadcasts against one gathered copy of ``m``. ``acc``
    (accumulator dtype) and ``buf`` (``m``'s dtype), shaped like ``m``,
    are reused when given."""
    if acc is None:
        acc = torch.empty(m.shape, dtype=accum_dtype(m.dtype),
                          device=m.device)
    if buf is None:
        buf = torch.empty_like(m)
    acc.zero_()
    for d in range(nbr.shape[0]):
        torch.index_select(m, axis, nbr[d], out=buf)
        acc.addcmul_(buf, mask[d])
    return acc


def spmm_ops(m: torch.Tensor, prep: OpsPrep) -> torch.Tensor:
    """``Y = M @ A`` for a ``(..., C, N)`` table by torch's own ops, on
    the table's device, in a fixed order (deterministic on the card)."""
    if m.device != prep.device:
        raise ValueError(f"spmm: table on {m.device}, operand on "
                         f"{prep.device}")
    if m.shape[-1] != prep.n:
        raise ValueError(f"spmm: table has {m.shape[-1]} vertices, the "
                         f"graph {prep.n}")
    flat = m.reshape(-1, prep.n)
    a = prep.arrays
    if prep.method == "dense":
        return (flat @ a["a"].to(m.dtype)).reshape(m.shape)
    if prep.method == "ell":
        out = ell_sweep(flat, a["nbr"], a["mask"], 1)
        return out.to(m.dtype).reshape(m.shape)
    acc = accum_dtype(m.dtype)
    # segment: each destination's run of the edge stream, in stream order
    out = torch.empty_like(flat)
    rows = flat.shape[0]
    step = max(1, min(rows, _SEGMENT_TARGET_ELEMS
                      // max(1, a["src"].numel())))
    for r0 in range(0, rows, step):
        contrib = flat[r0:r0 + step].t().index_select(0, a["src"]).to(acc)
        out[r0:r0 + step] = torch.segment_reduce(
            contrib, "sum", lengths=a["degrees"], axis=0).t()
    return out.reshape(m.shape)


def spmm_acc(m: torch.Tensor, prep: BsrPrep) -> torch.Tensor:
    """Plain ``(R, N) @ A`` in the accumulator dtype, block by block: the
    rows' source-tile slices are gathered per block, multiplied by the
    block, and summed into their destination tiles."""
    rows, n = m.shape
    acc = accum_dtype(m.dtype)
    tile, n_tiles = prep.tile, prep.n_tiles
    blocks = prep.blocks.to(acc)
    src = prep.src_tile.long()
    dst = prep.dst_tile.long()
    out = torch.zeros((rows, n_tiles, tile), dtype=acc, device=m.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, prep.n_blocks * tile))
    for r0 in range(0, rows, step):
        chunk = torch.nn.functional.pad(
            m[r0:r0 + step].to(acc), (0, n_tiles * tile - n))
        gathered = chunk.view(-1, n_tiles, tile)[:, src].transpose(0, 1)
        part = torch.bmm(gathered, blocks)               # (n_blocks, r, tile)
        out[r0:r0 + step].index_add_(1, dst, part.transpose(0, 1))
    return out.view(rows, n_tiles * tile)[:, :n]


def spmm_plain(m: torch.Tensor, prep: BsrPrep) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``(..., C, N) @ A`` in the
    storage dtype, accumulated in the accumulator dtype."""
    flat = m.reshape(-1, m.shape[-1])
    return spmm_acc(flat, prep).to(m.dtype).reshape(m.shape)


def _check_operands(name: str, prep: BsrPrep, *tables: torch.Tensor) -> int:
    """Device, dtype and layout checks shared by the BSR kernels' wrappers;
    returns the kernels' dtype code."""
    if prep.tile != _KERNEL_TILE:
        raise ValueError(f"{name}: the kernels take {_KERNEL_TILE}-wide "
                         f"blocks, got {prep.tile}")
    for t in tables:
        if t.device != prep.device:
            raise ValueError(f"{name}: table on {t.device}, operand on "
                             f"{prep.device}")
        if t.dtype != prep.dtype:
            raise TypeError(f"{name}: table dtype {t.dtype} differs from the "
                            f"operand's {prep.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tables must be contiguous")
        if t.shape[-1] != prep.n:
            raise ValueError(f"{name}: table has {t.shape[-1]} vertices, "
                             f"the graph {prep.n}")
    return card_dtype_code(prep.dtype)


def spmm(m: torch.Tensor, prep: BsrPrep | GatherPrep | OpsPrep
         ) -> torch.Tensor:
    """``Y = M @ A`` for a ``(..., C, N)`` table: the plain version on a
    CPU tensor, one launch of the prep's CUDA kernel on a CUDA tensor;
    an :class:`OpsPrep` runs torch's ops on either."""
    if isinstance(prep, OpsPrep):
        return spmm_ops(m, prep)
    if isinstance(prep, GatherPrep):
        return spmm_gather(m, prep)
    if m.device.type == "cpu":
        return spmm_plain(m, prep)
    code = _check_operands("spmm", prep, m)
    rows = m.numel() // max(1, m.shape[-1])
    out = torch.empty_like(m)
    if rows == 0 or prep.n == 0:
        return out.zero_()
    fn = _build.kernel("rt_spmm_bsr", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m.device).cuda_stream
    _build.check("spmm", fn(
        code, m.data_ptr(), rows, prep.n, prep.src_tile.data_ptr(),
        prep.tile_ptr.data_ptr(), prep.col_ptr.data_ptr(),
        prep.nz_src.data_ptr(), prep.n_tiles, out.data_ptr(), stream))
    spmm.launches += 1
    return out


spmm.launches = 0


def spmm_gather_plain(m: torch.Tensor, prep: GatherPrep) -> torch.Tensor:
    """The plain PyTorch version of the gather kernel: ``(..., C, N) @ A``
    in the storage dtype, accumulated in the accumulator dtype over runs
    of whole destination tiles, each run's source columns gathered and
    summed into their destinations. A run is cut at a tile boundary once it
    holds enough edges, so the gathered ``(rows, edges)`` block stays
    bounded at full graph size."""
    flat = m.reshape(-1, m.shape[-1])
    rows, n = flat.shape
    out = torch.zeros((rows, n), dtype=accum_dtype(m.dtype), device=m.device)
    if rows and prep.src.numel():
        src = prep.src.long()
        dst = torch.repeat_interleave(
            torch.arange(n, device=m.device), prep.row_ptr.diff())
        tile_ptr = prep.tile_ptr.cpu().numpy()
        step = max(1, _PLAIN_CHUNK_ELEMS // rows)
        cuts = [0]
        for t in range(1, len(tile_ptr)):
            if tile_ptr[t] - tile_ptr[cuts[-1]] >= step \
                    or t == len(tile_ptr) - 1:
                cuts.append(t)
        for t0, t1 in zip(cuts[:-1], cuts[1:]):
            e0, e1 = int(tile_ptr[t0]), int(tile_ptr[t1])
            if e1 > e0:
                out.index_add_(1, dst[e0:e1], flat[:, src[e0:e1]].to(out.dtype))
    return out.to(m.dtype).reshape(m.shape)


def spmm_gather(m: torch.Tensor, prep: GatherPrep) -> torch.Tensor:
    """``Y = M @ A`` over the edge stream for a ``(..., C, N)`` table: the
    plain version on a CPU tensor, one call of ``csrc/spmm_gather.cu`` on
    a CUDA tensor (its kernels once per chunk of rows)."""
    if m.device.type == "cpu":
        return spmm_gather_plain(m, prep)
    if m.device != prep.device:
        raise ValueError(f"spmm_gather: table on {m.device}, operand on "
                         f"{prep.device}")
    if not m.is_contiguous():
        raise ValueError("spmm_gather: tables must be contiguous")
    if m.shape[-1] != prep.n:
        raise ValueError(f"spmm_gather: table has {m.shape[-1]} vertices, "
                         f"the graph {prep.n}")
    code = card_dtype_code(m.dtype)
    rows = m.numel() // max(1, m.shape[-1])
    out = torch.empty_like(m)
    if rows == 0 or prep.n == 0:
        return out
    # the kernel's scratch (scratch_bytes): one vertex-major row chunk and
    # the hubs' partial sums, from the caching allocator
    chunk = _GATHER_LINE // m.element_size()
    scratch = torch.empty((prep.n, chunk), dtype=m.dtype, device=m.device)
    partials = torch.empty((prep.n_segments, chunk),
                           dtype=torch.float32, device=m.device)
    fn = _build.kernel("rt_spmm_gather", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m.device).cuda_stream
    _build.check("spmm_gather", fn(
        code, m.data_ptr(), rows, prep.n, prep.src.data_ptr(),
        prep.row_ptr.data_ptr(), prep.hub_degree, prep.seg.data_ptr(),
        prep.n_segments, prep.hub_vertex.data_ptr(),
        prep.hub_seg_ptr.data_ptr(), prep.n_hubs, scratch.data_ptr(),
        partials.data_ptr(), out.data_ptr(), stream))
    spmm_gather.launches += 1
    return out


spmm_gather.launches = 0


def spmm_row_chunk(m: torch.Tensor, q: int, rows: int) -> torch.Tensor:
    """Chunk ``q`` of the combination-row axis of a ``(..., C, N)`` table,
    rows ``q*rows`` to ``(q+1)*rows``, for the colorset-chunked eMA: each
    chunk is a self-contained SpMM operand (rows are independent). The last
    chunk is sliced short, not padded (the JAX package's ``spmm_row_chunks``
    pads, which would copy the whole table). At batch 1 the chunk is a view;
    at batch > 1 the slice is strided, and the kernels take contiguous
    tables, so it is copied (``(B, rows, N)``)."""
    c = m[..., q * rows:(q + 1) * rows, :]
    return c if c.is_contiguous() else c.contiguous()
