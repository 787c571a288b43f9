"""SpMM ``Y = M @ A``: the CUDA kernels' wrappers and their plain versions,
over two operands.

``prepare(graph, "bsr")`` puts the destination-sorted stream of 128x128
adjacency blocks (``Graph.bsr_layout``) on a device as its nonzero index,
never as dense blocks: each block's source and destination tile, the
per-destination-tile run pointer ``tile_ptr`` the CUDA kernels walk, and
each block's nonzeros by destination column (``col_ptr``, ``nz_src``:
``structure.block_nonzero_index``). The BSR SpMM, the fused and the group
kernels walk only those nonzeros, and so does the plain version
(:func:`spmm_acc`); the dense blocks exist only on the host
(``Graph.bsr``), so a social graph whose occupied blocks would take
hundreds of GB dense takes a few GB here.
``prepare(graph, "gather")`` puts the destination-sorted edge stream
(``Graph.edges_by_dst``, through :func:`gather_prep_from_edges`, which
takes any destination-sorted directed edges) there instead, with its
hubs' segments: no blocks, so it fits graphs whose dense blocks would not (a social graph's
edges scatter over millions of tile pairs). The gather kernel reads the
table through a vertex-major scratch of ``128 / itemsize`` rows, allocated
per call (:meth:`GatherPrep.scratch_bytes`). ``spmm(m, prep)`` applies
``Y = M @ A`` to a ``(..., C, N)``
table with the leading (batch) dimensions folded into rows — one launch
for a whole coloring batch, as in the JAX package's ``kernels/spmm/ops.py``
— and dispatches on the prep's kind.

On a CPU tensor :func:`spmm` runs the plain version (:func:`spmm_plain`,
:func:`spmm_gather_plain`) and ignores the launch shape; on a CUDA tensor
it launches ``csrc/spmm_bsr.cu`` or ``csrc/spmm_gather.cu``, or raises.
The launch shape (``c_block``: table rows a BSR block takes, destinations
a gather block holds) is today's default unless given, or chosen by the
autotuner with ``autotune=True`` (``kernels/autotune.py``).
``spmm.launches`` counts BSR launches, ``spmm_gather.launches`` the
gather wrapper's calls that reach the card (each launches a transpose, a
gather and, with hubs, a hub pass per chunk of rows); the autotuner's
sweeps count theirs apart, in ``.sweep_launches``.

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
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis.hlo import note_scratch
from repro_torch.device import accum_dtype, card_dtype_code, resolve_device
from repro_torch.graph.structure import Graph, block_nonzero_index
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as _autotune

__all__ = ["BsrPrep", "GatherPrep", "OpsPrep", "METHODS", "prepare",
           "from_arrays", "gather_prep_from_edges", "spmm", "spmm_plain",
           "spmm_ops", "ell_sweep", "spmm_gather", "spmm_gather_plain",
           "spmm_row_chunk", "bsr_shapes", "gather_shapes", "BSR_ROWS",
           "GATHER_DESTS"]

# operand kinds of prepare(): the JAX package's "pallas_bsr" and
# "pallas_gather" backends, then its XLA ones
METHODS = ("bsr", "gather", "segment", "ell", "dense")
# the backends torch's own ops run (OpsPrep)
OPS_METHODS = ("segment", "ell", "dense")

# elements of the plain version's gathered (rows, nonzeros) operand per
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
# the launch shapes csrc/spmm_bsr.cu and csrc/spmm_gather.cu compile, and
# their defaults (rt::SP_ROWS rows a BSR block; destinations a gather block)
BSR_ROWS = (2, 4, 8, 16, 32, 64)
# blocks of a destination tile's run the BSR walks sum into one partial
# before adding it to the column's total (rt::RUN_SEG in
# csrc/bsr_sparse_tile.cuh): a hub column's one long f32 chain loses
# precision (PERF.md §6)
RUN_SEG = 16
BSR_ROWS_DEFAULT = 32
GATHER_DESTS = (32, 64, 128)
GATHER_DESTS_DEFAULT = 128
_MAX_GRID_Y = 65535
_MAX_GRID_X = (1 << 31) - 1


@dataclasses.dataclass
class BsrPrep:
    """The BSR adjacency on one device as its nonzero index (shared by the
    SpMM, fused and group kernels); it holds no dense blocks. Block ``b``
    is ``A[src_tile[b] tile, dst_tile[b] tile]``; destination tile ``t``
    owns blocks ``tile_ptr[t]:tile_ptr[t+1]``. ``dtype`` is the storage
    dtype of the tables it multiplies; ``reorder`` names the vertex order
    it was built in (the autotuner's key)."""

    n: int
    n_blocks: int
    src_tile: torch.Tensor  # (n_blocks,) int32
    dst_tile: torch.Tensor  # (n_blocks,) int32, ascending
    tile_ptr: torch.Tensor  # (n_tiles + 1,) int32
    tile: int
    n_tiles: int
    # block b's column c sums source rows nz_src[col_ptr[b, c]:col_ptr[b,
    # c + 1]] of its source tile (structure.block_nonzero_index)
    col_ptr: torch.Tensor   # (n_blocks, tile + 1) int32
    nz_src: torch.Tensor    # (nnz,) uint8
    device: torch.device
    dtype: torch.dtype
    reorder: str = ""

    @property
    def nnz(self) -> int:
        return int(self.nz_src.numel())

    @property
    def index_bytes(self) -> int:
        """Bytes of the nonzero index the BSR SpMM and fused kernels
        walk."""
        return (self.col_ptr.numel() * self.col_ptr.element_size()
                + self.nz_src.numel())

    @property
    def nbytes(self) -> int:
        """Device bytes of the whole operand: the nonzero index and the
        block stream's tiles and run pointer."""
        return self.index_bytes + sum(
            t.numel() * t.element_size()
            for t in (self.src_tile, self.dst_tile, self.tile_ptr))


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
    reorder: str = ""          # the vertex order (the autotuner's key)

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
    """A prep from a host block stream as arrays (numpy or torch; the
    reference's ``blocks``): builds the run pointer from the sorted
    ``dst_tile`` and the nonzero index from the blocks' nonzeros, and keeps
    no blocks. ``device=None`` is CUDA."""
    blocks = torch.as_tensor(blocks)
    nz = [t.cpu().numpy() for t in torch.nonzero(blocks, as_tuple=True)]
    n_blocks, tile = int(blocks.shape[0]), int(blocks.shape[-1])
    col_ptr, nz_src = block_nonzero_index(n_blocks, tile, *nz)
    return _bsr_prep(n, n_blocks, tile, src_tile, dst_tile, col_ptr, nz_src,
                     dtype=dtype, device=resolve_device(device))


def _bsr_prep(n, n_blocks, tile, src_tile, dst_tile, col_ptr, nz_src, *,
              dtype, device, reorder: str = "") -> BsrPrep:
    dst_np = np.array(dst_tile, np.int32)     # a writable copy for torch
    if np.any(np.diff(dst_np) < 0):
        raise ValueError("dst_tile must be sorted ascending")
    n_tiles = -(-n // tile)
    tile_ptr = np.searchsorted(dst_np, np.arange(n_tiles + 1)).astype(np.int32)
    if np.any(np.diff(tile_ptr) == 0):
        raise ValueError("every destination tile needs at least one block")
    col_ptr = torch.as_tensor(col_ptr, device=device)
    return BsrPrep(
        n=n, n_blocks=int(n_blocks),
        src_tile=torch.as_tensor(np.array(src_tile, np.int32),
                                 device=device),
        dst_tile=torch.as_tensor(dst_np, device=device),
        tile_ptr=torch.as_tensor(tile_ptr, device=device),
        tile=tile, n_tiles=n_tiles, col_ptr=col_ptr,
        nz_src=torch.as_tensor(nz_src, device=device),
        # the tensors' own device: "cuda" resolves to "cuda:0" there
        device=col_ptr.device, dtype=dtype, reorder=reorder or "")


def prepare(g: Graph, method: str = "bsr", *, dtype=torch.float32,
            device=None, tile: int = 128, reorder: str = ""
            ) -> BsrPrep | GatherPrep | OpsPrep:
    """The SpMM operand of ``g`` on ``device`` (``None`` is CUDA).

    ``"bsr"``: the block stream's nonzero index, built on the host; no
    dense block is made on any device. ``dtype`` is the storage dtype of
    the tables it will multiply. ``"gather"``: the edge stream, its run
    pointers and the segments of its hubs (vertices of more than
    ``HUB_DEGREE`` edges). It holds no values, so ``dtype`` does not
    enter. ``"segment"``, ``"ell"`` and ``"dense"``: the edge stream, the
    padded neighbor table (``Graph.ell``) or the dense adjacency
    (:class:`OpsPrep`). ``reorder`` tags the BSR and gather operands with
    the vertex order ``g`` is in (the autotuner's key)."""
    if method not in METHODS:
        raise ValueError(f"unknown SpMM operand {method!r}; "
                         f"choose from {METHODS}")
    device = resolve_device(device)
    if method == "gather":
        prep = _gather_prep(g, device, tile)
        prep.reorder = reorder or ""
        return prep
    if method in OPS_METHODS:
        return _ops_prep(g, method, dtype, device)
    lay = g.padded(tile).bsr_layout(tile)
    index = block_nonzero_index(lay.n_blocks, tile, lay.edge_block,
                                lay.edge_src, lay.edge_dst)
    return _bsr_prep(g.n, lay.n_blocks, tile, lay.src_tile, lay.dst_tile,
                     *index, dtype=dtype, device=device, reorder=reorder)


def _gather_prep(g: Graph, device, tile: int = 128,
                 hub_degree: int = HUB_DEGREE) -> GatherPrep:
    """:func:`prepare`'s gather operand, its hubs cut at ``hub_degree``
    edges (``g.n`` cuts none)."""
    return gather_prep_from_edges(g.n, *g.edges_by_dst, device=device,
                                  tile=tile, hub_degree=hub_degree)


def gather_prep_from_edges(n: int, src, dst, *, device=None,
                           tile: int = 128,
                           hub_degree: int = HUB_DEGREE) -> GatherPrep:
    """The gather operand of the directed edges ``src[i] -> dst[i]`` on
    ``n`` vertices (numpy arrays sorted by destination, else
    ``ValueError``; ``device=None`` is CUDA): each destination sums its
    sources in the order given, its hubs cut at ``hub_degree`` edges.
    Nothing is symmetrised or deduplicated, so it holds one ``(destination
    shard, source block)`` piece of the distributed ring
    (``core/distributed``) as well as a whole graph's ``edges_by_dst``."""
    if hub_degree < 1:
        raise ValueError(f"hub_degree must be positive, got {hub_degree}")
    src, dst = np.asarray(src), np.asarray(dst)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src and dst must be two (m,) arrays")
    if len(src) and not (0 <= min(src.min(), dst.min())
                         and max(src.max(), dst.max()) < n):
        raise ValueError(f"edge endpoints outside [0, {n})")
    if np.any(np.diff(dst) < 0):
        raise ValueError("edges must be sorted by destination")
    src = src.astype(np.int32)
    row_ptr = np.searchsorted(dst, np.arange(n + 1, dtype=np.int64)
                              ).astype(np.int64)
    n_tiles = -(-n // tile)
    tile_ptr = row_ptr[np.minimum(
        np.arange(n_tiles + 1, dtype=np.int64) * tile, n)]
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
    device = resolve_device(device)
    return GatherPrep(
        n=n, src=torch.as_tensor(src, device=device),
        row_ptr=torch.as_tensor(row_ptr, device=device),
        tile_ptr=torch.as_tensor(tile_ptr, device=device), tile=tile,
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


def _bsr_edges(prep: BsrPrep):
    """The nonzeros of a BSR operand in the index's order (blocks in
    stream order, each block's columns ascending, a column's sources
    ascending) as ``(src, slot, slot_dst)`` on its device: nonzero ``j`` of
    column ``c`` of block ``b`` reads source vertex ``src_tile[b] * tile +
    nz_src[j]`` into partial ``slot[j] = seg(b) * tile + c``, where
    ``seg(b)`` numbers the ``RUN_SEG``-block segments of every destination
    tile's run over the whole stream; partial ``s`` belongs to destination
    vertex ``slot_dst[s]``. All int64."""
    tile, dev = prep.tile, prep.device
    tile_ptr = prep.tile_ptr.long()
    runs = tile_ptr.diff()
    n_seg = (runs + RUN_SEG - 1) // RUN_SEG
    seg_base = torch.cumsum(n_seg, 0) - n_seg
    dst_tile = prep.dst_tile.long()
    pos = torch.arange(prep.n_blocks, device=dev) - tile_ptr[dst_tile]
    block_seg = seg_base[dst_tile] + pos // RUN_SEG
    counts = prep.col_ptr.diff(dim=1).reshape(-1)
    col = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), counts,
        output_size=prep.nnz)
    blk = col // tile
    src = prep.src_tile.long()[blk] * tile + prep.nz_src.long()
    slot = block_seg[blk] * tile + col % tile
    seg_tile = torch.repeat_interleave(
        torch.arange(prep.n_tiles, device=dev), n_seg)
    slot_dst = (seg_tile[:, None] * tile
                + torch.arange(tile, device=dev)).reshape(-1)
    return src, slot, slot_dst


def spmm_acc(m: torch.Tensor, prep: BsrPrep) -> torch.Tensor:
    """Plain ``(R, N) @ A`` in the accumulator dtype over the nonzero
    index, in the kernels' order: column ``c`` of block ``b`` sums the
    source rows ``src_tile[b] * tile + nz_src[col_ptr[b, c]:col_ptr[b, c +
    1]]`` into destination vertex ``dst_tile[b] * tile + c``, each
    ``RUN_SEG`` blocks of a destination tile's run into a zeroed partial,
    the partials then added in run order. The rows go through in chunks,
    each one gather of every nonzero's source column and two
    ``index_add_``; on the CPU these add in index order, so the sums are
    the kernels' bit for bit (on the card ``index_add_`` adds in no fixed
    order)."""
    rows, n = m.shape
    acc = accum_dtype(m.dtype)
    n_pad = prep.n_tiles * prep.tile
    out = torch.zeros((rows, n_pad), dtype=acc, device=m.device)
    if rows == 0 or prep.nnz == 0:
        return out[:, :n]
    src, slot, slot_dst = _bsr_edges(prep)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(prep.nnz, slot_dst.numel()))
    for r0 in range(0, rows, step):
        chunk = torch.nn.functional.pad(m[r0:r0 + step].to(acc),
                                        (0, n_pad - n))
        part = torch.zeros((chunk.shape[0], slot_dst.numel()), dtype=acc,
                           device=m.device)
        part.index_add_(1, slot, chunk.index_select(1, src))
        out[r0:r0 + step].index_add_(1, slot_dst, part)
    return out[:, :n]


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


def bsr_shapes(rows: int, candidates=BSR_ROWS) -> tuple[int, ...]:
    """The BSR SpMM's launch shapes (rows a CUDA block takes) among
    ``candidates`` that a ``rows``-row table can launch: compiled
    (:data:`BSR_ROWS`), within the grid's 65,535 row blocks, and no wider
    than the narrowest shape that covers the rows, except the default."""
    cover = min((c for c in candidates if c >= rows), default=None)
    return tuple(c for c in candidates
                 if c in BSR_ROWS and -(-rows // c) <= _MAX_GRID_Y
                 and (c <= rows or c == cover or c == BSR_ROWS_DEFAULT))


def _bsr_launch(m: torch.Tensor, prep: BsrPrep, rows_per_block: int,
                out: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/spmm_bsr.cu`` at ``rows_per_block`` into
    ``out``; counts nothing."""
    rows = m.numel() // max(1, m.shape[-1])
    fn = _build.kernel("rt_spmm_bsr", [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    stream = torch.cuda.current_stream(m.device).cuda_stream
    _build.check("spmm", fn(
        card_dtype_code(prep.dtype), rows_per_block, m.data_ptr(), rows,
        prep.n, prep.src_tile.data_ptr(), prep.tile_ptr.data_ptr(),
        prep.col_ptr.data_ptr(), prep.nz_src.data_ptr(), prep.n_tiles,
        out.data_ptr(), stream))
    return out


def _bsr_sweep(m: torch.Tensor, prep: BsrPrep, out: torch.Tensor):
    """The autotuner's runner: ``c -> None``, one launch at shape ``c``
    into the wrapper's own ``out`` (its launch then overwrites it), counted
    in ``spmm.sweep_launches``."""

    def run(c):
        _bsr_launch(m, prep, c, out)
        spmm.sweep_launches += 1
    return run


def spmm(m: torch.Tensor, prep: BsrPrep | GatherPrep | OpsPrep, *,
         c_block: int | None = None, autotune: bool = False) -> torch.Tensor:
    """``Y = M @ A`` for a ``(..., C, N)`` table: the plain version on a
    CPU tensor, one launch of the prep's CUDA kernel on a CUDA tensor;
    an :class:`OpsPrep` runs torch's ops on either.

    ``c_block`` is the kernel's launch shape, the reference's keyword: on
    the BSR kernel the table rows a CUDA block takes (:data:`BSR_ROWS`,
    default 32), on the gather kernel the destinations a block holds
    (:data:`GATHER_DESTS`, default 128). ``autotune=True`` sweeps the
    launchable shapes once per key (:func:`~repro_torch.kernels.autotune.
    spmm_c_block`). Both are ignored on a CPU tensor and by an
    :class:`OpsPrep`."""
    if isinstance(prep, OpsPrep):
        return spmm_ops(m, prep)
    if isinstance(prep, GatherPrep):
        return spmm_gather(m, prep, c_block=c_block, autotune=autotune)
    if m.device.type == "cpu":
        return spmm_plain(m, prep)
    _check_operands("spmm", prep, m)
    rows = m.numel() // max(1, m.shape[-1])
    out = torch.empty_like(m)
    if rows == 0 or prep.n == 0:
        return out.zero_()
    if c_block is None:
        c_block = BSR_ROWS_DEFAULT
        if autotune:
            c_block = _autotune.spmm_c_block(
                m, _bsr_sweep(m, prep, out), kind="bsr",
                operand=(prep.n_blocks, prep.nnz), reorder=prep.reorder,
                candidates=bsr_shapes(rows, _autotune.SPMM_C_BLOCK_CANDIDATES))
    elif c_block not in bsr_shapes(rows, (c_block,)):
        raise ValueError(f"spmm: the BSR kernel cannot take {rows} rows "
                         f"at {c_block} a block; it compiles {BSR_ROWS}")
    _bsr_launch(m, prep, c_block, out)
    spmm.launches += 1
    return out


spmm.launches = 0
spmm.sweep_launches = 0


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


def gather_shapes(prep: GatherPrep, candidates=GATHER_DESTS
                  ) -> tuple[int, ...]:
    """The gather SpMM's launch shapes (destinations a block holds) among
    ``candidates`` that ``prep`` can launch: compiled
    (:data:`GATHER_DESTS`) and within the grid's ``2^31 - 1`` blocks."""
    seg_blocks = -(-prep.n_segments // 32)
    return tuple(d for d in candidates if d in GATHER_DESTS
                 and seg_blocks + -(-prep.n // d) <= _MAX_GRID_X)


def gather_out(m: torch.Tensor) -> torch.Tensor:
    """The gather SpMM's output for a ``(..., C, N)`` table: ``m``'s
    shape, dtype and device. The op's CUDA and fake implementations both
    allocate it here."""
    return torch.empty_like(m, memory_format=torch.contiguous_format)


def gather_scratch(m: torch.Tensor, n_segments: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch for one call (:meth:`GatherPrep.scratch_bytes`),
    allocated after the output and freed when the call returns: one
    vertex-major ``(n, 128 / itemsize)`` row chunk in ``m``'s dtype and
    the hubs' f32 partial sums, from the caching allocator."""
    chunk = _GATHER_LINE // m.element_size()
    return (torch.empty((m.shape[-1], chunk), dtype=m.dtype,
                        device=m.device),
            torch.empty((n_segments, chunk), dtype=torch.float32,
                        device=m.device))


def _gather_launch(m, src, row_ptr, hub_vertex, hub_seg_ptr, seg,
                   hub_degree: int, dests: int, out) -> torch.Tensor:
    """One call of ``csrc/spmm_gather.cu`` at ``dests`` destinations a
    block into ``out``, with its own scratch; counts nothing."""
    n = m.shape[-1]
    rows = m.numel() // max(1, n)
    scratch, partials = gather_scratch(m, int(seg.shape[0]))
    fn = _build.kernel("rt_spmm_gather", [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m.device).cuda_stream
    _build.check("spmm_gather", fn(
        card_dtype_code(m.dtype), dests, m.data_ptr(), rows, n,
        src.data_ptr(), row_ptr.data_ptr(), hub_degree, seg.data_ptr(),
        int(seg.shape[0]), hub_vertex.data_ptr(), hub_seg_ptr.data_ptr(),
        int(hub_vertex.numel()), scratch.data_ptr(), partials.data_ptr(),
        out.data_ptr(), stream))
    return out


# repro_torch::spmm_gather, registered through the low-level library API:
# a custom_op's first call imports torch._dynamo (seconds) and its calls
# cost about three times as much dispatch
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("spmm_gather(Tensor m, Tensor src, Tensor row_ptr, "
            "Tensor hub_vertex, Tensor hub_seg_ptr, Tensor seg, "
            "int hub_degree, int c_block) -> Tensor")


def _spmm_gather_cuda(m, src, row_ptr, hub_vertex, hub_seg_ptr, seg,
                      hub_degree, c_block):
    """``repro_torch::spmm_gather`` on the card: one launch of the gather
    kernel on the prep's tensors at ``c_block`` destinations a block into
    a new output (:func:`gather_out`), counted in
    ``spmm_gather.launches``."""
    out = _gather_launch(m, src, row_ptr, hub_vertex, hub_seg_ptr, seg,
                         hub_degree, c_block, gather_out(m))
    spmm_gather.launches += 1
    return out


_LIB.impl("spmm_gather", _spmm_gather_cuda, "CUDA")


@torch.library.register_fake("repro_torch::spmm_gather", lib=_LIB)
def _(m, src, row_ptr, hub_vertex, hub_seg_ptr, seg, hub_degree, c_block):
    out = gather_out(m)
    # the scratch the CUDA path holds beside its output, for a traced
    # step's temporary bytes
    note_scratch(out, *gather_scratch(m, int(seg.shape[0])))
    return out


@register_flop_formula(torch.ops.repro_torch.spmm_gather, get_raw=True)
def _spmm_gather_flops(m, src, *args, out_val=None, **kwargs) -> int:
    """The reference's nnz-based count: 2 flops an edge a table row."""
    return 2 * src.numel() * (m.numel() // max(1, m.shape[-1]))


def _gather_sweep(m: torch.Tensor, prep: GatherPrep, out: torch.Tensor):
    """The autotuner's runner: ``d -> None``, one call at shape ``d`` into
    the wrapper's own ``out`` (its call then overwrites it), counted in
    ``spmm_gather.sweep_launches``."""

    def run(d):
        _gather_launch(m, prep.src, prep.row_ptr, prep.hub_vertex,
                       prep.hub_seg_ptr, prep.seg, prep.hub_degree, d, out)
        spmm_gather.sweep_launches += 1
    return run


def spmm_gather(m: torch.Tensor, prep: GatherPrep, *,
                c_block: int | None = None,
                autotune: bool = False) -> torch.Tensor:
    """``Y = M @ A`` over the edge stream for a ``(..., C, N)`` table: the
    plain version on a CPU tensor, one call of ``csrc/spmm_gather.cu`` on
    a CUDA tensor (its kernels once per chunk of rows), through the op
    ``repro_torch::spmm_gather``, at ``c_block`` destinations a gather
    block (default 128), or the autotuner's choice with ``autotune=True``.
    A fake CUDA table (a traced step, ``analysis/hlo``) takes the same
    path to the op's fake implementation, which launches nothing."""
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
    card_dtype_code(m.dtype)
    rows = m.numel() // max(1, m.shape[-1])
    if rows == 0 or prep.n == 0:
        return gather_out(m)
    if c_block is None:
        c_block = GATHER_DESTS_DEFAULT
        if autotune:
            # the sweep launches into a table the op's output then takes
            # the place of, so the call's peak does not grow
            c_block = _autotune.spmm_c_block(
                m, _gather_sweep(m, prep, gather_out(m)), kind="gather",
                operand=(int(prep.src.numel()), prep.n_segments),
                reorder=prep.reorder,
                candidates=gather_shapes(
                    prep, _autotune.GATHER_BLOCK_CANDIDATES))
    elif c_block not in gather_shapes(prep, (c_block,)):
        raise ValueError(f"spmm_gather: cannot launch {c_block} "
                         f"destinations a block; it compiles {GATHER_DESTS}")
    return torch.ops.repro_torch.spmm_gather(
        m, prep.src, prep.row_ptr, prep.hub_vertex, prep.hub_seg_ptr,
        prep.seg, prep.hub_degree, c_block)


spmm_gather.launches = 0
spmm_gather.sweep_launches = 0


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
