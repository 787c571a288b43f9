"""eMA ``out[j] = sum_l m_a[IA[j, l]] * y_p[IP[j, l]]``: the CUDA kernel's
wrapper and its plain version (paper Algorithm 4 line 7).

Tables are ``(C, N)`` or batched ``(B, C, N)``; a batch is one launch.
bf16 storage accumulates in f32 and rounds once, at the store — the
storage/accumulator contract of the JAX package's ``kernels/ema/ops.py``.
On a CPU tensor :func:`ema` runs :func:`ema_plain`; on a CUDA tensor it
launches ``csrc/ema.cu`` or raises, at the launch shape ``(s_block,
n_block)`` it is given, today's default, or the autotuner's choice
(``autotune=True``; ``kernels/autotune.py``). The autotuner's sweep
launches count in ``ema.sweep_launches``, apart from ``ema.launches``.

The colorset-chunked eMA (:func:`ema_chunked`) never holds a node's whole
passive neighbor-sum table: it walks the ``C(k, t_p)`` passive axis a
chunk of rows at a time, one SpMM per chunk, and adds that chunk's
(active, passive, output) pairs into one accumulating output with
:func:`ema_chunk_acc` — ``csrc/ema_chunk.cu`` on the card, its plain
version (the reference's pair-block scatter-adds, by ``index_add_``) on
the CPU. The pairs come from :func:`pack_chunked_splits`, the JAX package's
packing array for array.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.analysis.hlo import note_scratch
from repro_torch.device import accum_dtype, card_dtype_code
from repro_torch.kernels import _build
from repro_torch.kernels import autotune as _autotune

__all__ = ["ema", "ema_plain", "ema_path", "ema_shapes", "ema_sweep_launch",
           "ChunkedSplits", "ChunkWalk", "pack_chunked_splits",
           "chunk_walk", "ema_chunk_acc", "ema_chunk_acc_plain",
           "ema_chunked"]

# elements of one (batch, rows, N) accumulator block of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 27
# csrc/ema.cu's launch shapes (s_block, n_block): the staged path (s_block
# 0) at slice widths _STAGED_W, the direct path at _DIRECT_ROWS output rows
# of _DIRECT_COLS columns; each path's default first
_STAGED_W = (32, 16, 64)
_DIRECT_ROWS = (8, 4, 16)
_DIRECT_COLS = 256
# the staged path is taken for more output rows than a direct block's
# default and a 32-column slice that fits a block's shared memory
# (_build.SMEM_LIMIT), whatever shape the autotuner then picks
_STAGED_MIN_S = 8


def ema_plain(m_a: torch.Tensor, y_p: torch.Tensor, ia: torch.Tensor,
              ip: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (the JAX package's ``ema_xla``): for each
    split ``l``, gather rows and multiply-add in the accumulator dtype.
    The output has ``m_a``'s dtype; ``y_p`` may be wider (the fused plain
    version passes its f32 neighbor sums). Output rows are taken in chunks
    so the working set stays bounded at full graph size."""
    acc_dt = accum_dtype(m_a.dtype)
    s, l = ia.shape
    n = m_a.shape[-1]
    lead = m_a.shape[:-2]
    ia, ip = ia.to(m_a.device).long(), ip.to(m_a.device).long()
    out = torch.empty(lead + (s, n), dtype=m_a.dtype, device=m_a.device)
    per_row = max(1, m_a.numel() // max(1, m_a.shape[-2]))
    step = max(1, _PLAIN_CHUNK_ELEMS // per_row)
    for s0 in range(0, s, step):
        rows = slice(s0, s0 + step)
        acc = torch.zeros(lead + (min(step, s - s0), n), dtype=acc_dt,
                          device=m_a.device)
        for q in range(l):
            acc += (m_a.index_select(-2, ia[rows, q]).to(acc_dt)
                    * y_p.index_select(-2, ip[rows, q]).to(acc_dt))
        out[..., rows, :] = acc
    return out


def ema_path(c_a: int, c_p: int, s: int, dtype: torch.dtype) -> str:
    """``"staged"`` or ``"direct"``: the path the eMA kernel takes for these
    table heights, ``S`` output rows and storage dtype (csrc/ema.cu)."""
    slice_bytes = (c_a + c_p) * _STAGED_W[0] * dtype.itemsize
    fits = slice_bytes <= _build.SMEM_LIMIT
    return "staged" if s > _STAGED_MIN_S and fits else "direct"


def _shape_fits(c_a, c_p, s, l, dtype, shape) -> bool:
    s_block, n_block = shape
    if ema_path(c_a, c_p, s, dtype) == "staged":
        return (s_block == 0 and n_block in _STAGED_W
                and (c_a + c_p) * n_block * dtype.itemsize
                <= _build.SMEM_LIMIT)
    return (n_block == _DIRECT_COLS and s_block in _DIRECT_ROWS
            and 2 * s_block * l * 4 <= _build.SMEM_LIMIT)


def ema_shapes(m_a: torch.Tensor, y_p: torch.Tensor, ia: torch.Tensor,
               candidates=_autotune.EMA_BLOCK_CANDIDATES
               ) -> tuple[tuple[int, int], ...]:
    """The launch shapes among ``candidates`` the kernel can take for these
    operands: shapes of the path it takes (:func:`ema_path`) that fit a
    block's shared memory."""
    s, l = ia.shape
    return tuple(tuple(c) for c in candidates
                 if _shape_fits(m_a.shape[-2], y_p.shape[-2], s, l,
                                m_a.dtype, c))


def _check(m_a, y_p, ia, ip) -> None:
    if m_a.shape[:-2] != y_p.shape[:-2] or m_a.shape[-1] != y_p.shape[-1]:
        raise ValueError(f"eMA tables disagree: {tuple(m_a.shape)} vs "
                         f"{tuple(y_p.shape)}")
    if m_a.dtype != y_p.dtype:
        raise TypeError(f"eMA tables differ in dtype: {m_a.dtype}, "
                        f"{y_p.dtype}")
    for t in (m_a, y_p, ia, ip):
        if t.device != m_a.device or not t.is_contiguous():
            raise ValueError("eMA operands must be contiguous, on one device")
    if ia.dtype != torch.int32 or ip.dtype != torch.int32 \
            or ia.shape != ip.shape:
        raise TypeError("split tables must be two int32 (S, L) tensors")
    card_dtype_code(m_a.dtype)


def _pairs_scratch(ia: torch.Tensor) -> torch.Tensor:
    """The staged path's split table for one launch: two terms' row
    offsets to an int4."""
    s, l = ia.shape
    return torch.empty(s * ((l + 1) // 2) * 4, dtype=torch.int32,
                       device=ia.device)


def _launch(m_a, y_p, ia, ip, shape, out) -> torch.Tensor:
    """One launch of ``csrc/ema.cu`` at ``shape`` into ``out``, with its
    own split-pair scratch; counts nothing."""
    s, l = ia.shape
    n = m_a.shape[-1]
    batch = m_a.numel() // max(1, m_a.shape[-2] * n)
    pairs = _pairs_scratch(ia)
    fn = _build.kernel("rt_ema", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m_a.device).cuda_stream
    _build.check("ema", fn(
        card_dtype_code(m_a.dtype), shape[0], shape[1], m_a.data_ptr(),
        y_p.data_ptr(), ia.data_ptr(), ip.data_ptr(), s, l, m_a.shape[-2],
        y_p.shape[-2], n, batch, pairs.data_ptr(), out.data_ptr(), stream))
    return out


def _empty_out(m_a, ia) -> torch.Tensor:
    """The eMA's output, ``(..., S, N)`` in ``m_a``'s dtype on its device:
    the op's CUDA and fake implementations both allocate it here."""
    return torch.empty(m_a.shape[:-2] + (ia.shape[0], m_a.shape[-1]),
                       dtype=m_a.dtype, device=m_a.device)


# repro_torch::ema, registered through the low-level library API (see
# kernels/spmm/ops.py's repro_torch::spmm_gather)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ema(Tensor m_a, Tensor y_p, Tensor ia, Tensor ip, "
            "int s_block, int n_block) -> Tensor")


def _ema_cuda(m_a, y_p, ia, ip, s_block, n_block):
    """``repro_torch::ema`` on the card: one launch of the eMA kernel at
    ``(s_block, n_block)`` into a new output (:func:`_empty_out`),
    counted in ``ema.launches``."""
    out = _launch(m_a, y_p, ia, ip, (s_block, n_block), _empty_out(m_a, ia))
    ema.launches += 1
    return out


_LIB.impl("ema", _ema_cuda, "CUDA")


@torch.library.register_fake("repro_torch::ema", lib=_LIB)
def _(m_a, y_p, ia, ip, s_block, n_block):
    out = _empty_out(m_a, ia)
    note_scratch(out, _pairs_scratch(ia))   # the CUDA path's, beside it
    return out


@register_flop_formula(torch.ops.repro_torch.ema, get_raw=True)
def _ema_flops(m_a, y_p, ia, *args, out_val=None, **kwargs) -> int:
    """The reference's count: 2 flops a (vertex, output row, split) of
    every table of the batch."""
    s, l = ia.shape
    return 2 * (m_a.numel() // max(1, m_a.shape[-2])) * s * l


def ema_sweep_launch(m_a, y_p, ia, ip, s_block: int, n_block: int,
                     out: torch.Tensor):
    """The autotuner's runner at one shape: a zero-argument callable that
    launches the kernel into ``out`` (a table the op's output then takes
    the place of), each launch counted in ``ema.sweep_launches``."""

    def run():
        _launch(m_a, y_p, ia, ip, (s_block, n_block), out)
        ema.sweep_launches += 1
    return run


def ema(m_a: torch.Tensor, y_p: torch.Tensor, ia: torch.Tensor,
        ip: torch.Tensor, *, s_block: int | None = None,
        n_block: int | None = None, autotune: bool = False) -> torch.Tensor:
    """eMA of ``(..., Ca, N)`` and ``(..., Cp, N)`` tables with ``(S, L)``
    int32 split tables: the plain version on CPU tensors, one launch of the
    CUDA kernel on CUDA tensors, through the op ``repro_torch::ema``. A
    fake CUDA table (a traced step, ``analysis/hlo``) takes the same path
    to the op's fake implementation, which launches nothing.

    ``(s_block, n_block)`` is the launch shape, the reference's keywords
    with the port's meanings: the output rows and the columns a CUDA block
    owns. The staged path's block owns every output row (``s_block`` 0)
    and a slice of ``n_block`` = 16, 32 (default) or 64 columns; the direct
    path's ``s_block`` = 4, 8 (default) or 16 rows of ``n_block`` = 256
    columns. The path is the kernel's own choice (:func:`ema_path`); a
    shape of the other path raises. A missing half takes the path's
    default; ``autotune=True`` sweeps the path's shapes once per key
    (:func:`~repro_torch.kernels.autotune.ema_blocks`). All are ignored on
    CPU tensors."""
    if m_a.device.type == "cpu":
        return ema_plain(m_a, y_p, ia, ip)
    _check(m_a, y_p, ia, ip)
    s, l = ia.shape
    c_a, c_p = m_a.shape[-2], y_p.shape[-2]
    if math.prod(m_a.shape[:-2]) * s * m_a.shape[-1] == 0:
        return _empty_out(m_a, ia)
    if autotune and (s_block is None or n_block is None):
        s_block, n_block = _autotune.ema_blocks(m_a, y_p, ia, ip)
    path = ema_path(c_a, c_p, s, m_a.dtype)
    default = ((0, _STAGED_W[0]) if path == "staged"
               else (_DIRECT_ROWS[0], _DIRECT_COLS))
    shape = (default[0] if s_block is None else s_block,
             default[1] if n_block is None else n_block)
    if not _shape_fits(c_a, c_p, s, l, m_a.dtype, shape):
        raise ValueError(f"ema: the {path} path cannot launch (s_block, "
                         f"n_block) = {shape} here")
    return torch.ops.repro_torch.ema(m_a, y_p, ia, ip, *shape)


ema.launches = 0
ema.sweep_launches = 0


# --------------------------------------------------------------------------
# the colorset-chunked eMA
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChunkedSplits:
    """Static pair tables for the colorset-chunked eMA of one plan node.

    The (color set, split) pairs of the node's ``(IA, IP)`` tables are
    grouped by which passive-axis chunk their ``IP`` rank falls in, so each
    chunk's pairs can be applied the moment that slice of the SpMM output
    exists. All arrays are ``(n_chunks, pairs_pad)`` with ``pairs_pad`` a
    multiple of ``pair_block`` (padding pairs have mask 0).
    """

    out_idx: np.ndarray    # output color-set rank of each pair
    a_idx: np.ndarray      # active-child rank
    p_loc: np.ndarray      # passive rank, local to the chunk
    mask: np.ndarray       # 1.0 for real pairs
    n_chunks: int
    chunk_rows: int        # passive rows per chunk (the last may be short)
    n_out_rows: int        # C(k, t)
    pair_block: int


def pack_chunked_splits(ia, ip, n_passive_rows: int, n_chunks: int,
                        pair_block: int = 128) -> ChunkedSplits:
    """Host-side regrouping of split tables for :func:`ema_chunked` (the
    JAX package's arrays, element for element)."""
    ia = np.asarray(ia)
    ip = np.asarray(ip)
    s, l = ia.shape
    r = -(-n_passive_rows // n_chunks)
    jj = np.repeat(np.arange(s, dtype=np.int32), l)
    aa = ia.ravel().astype(np.int32)
    pp = ip.ravel().astype(np.int32)
    q_of = pp // r
    counts = np.bincount(q_of, minlength=n_chunks)
    p_max = int(counts.max()) if len(counts) else 1
    p_pad = max(pair_block, -(-p_max // pair_block) * pair_block)
    out_idx = np.zeros((n_chunks, p_pad), np.int32)
    a_idx = np.zeros((n_chunks, p_pad), np.int32)
    p_loc = np.zeros((n_chunks, p_pad), np.int32)
    mask = np.zeros((n_chunks, p_pad), np.float32)
    order = np.argsort(q_of, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)])
    for q in range(n_chunks):
        sel = order[offs[q]: offs[q + 1]]
        m = len(sel)
        out_idx[q, :m] = jj[sel]
        a_idx[q, :m] = aa[sel]
        p_loc[q, :m] = pp[sel] - q * r
        mask[q, :m] = 1.0
    return ChunkedSplits(out_idx=out_idx, a_idx=a_idx, p_loc=p_loc,
                         mask=mask, n_chunks=n_chunks, chunk_rows=r,
                         n_out_rows=s, pair_block=pair_block)


@dataclasses.dataclass(frozen=True)
class ChunkWalk:
    """The real pairs of a :class:`ChunkedSplits` on one device, as the
    chunk-accumulate kernel walks them: chunk ``q`` owns the entries
    ``entry_ptr[q]:entry_ptr[q+1]``, one per output row it touches (rows
    ascending); entry ``e`` adds the pairs ``row_ptr[e]:row_ptr[e+1]``
    (active row ``pair_a``, chunk-local passive row ``pair_p``, in the
    pack's order) into output row ``rows[e]``. The padding pairs are
    gone."""

    pack: ChunkedSplits
    rows: torch.Tensor       # (n_entries,) int32
    row_ptr: torch.Tensor    # (n_entries + 1,) int32
    pair_a: torch.Tensor     # (n_pairs,) int32
    pair_p: torch.Tensor     # (n_pairs,) int32
    pair_entry: torch.Tensor  # (n_pairs,) int64, the plain version's
    entry_ptr: np.ndarray    # (n_chunks + 1,) host copy
    pair_ptr: np.ndarray     # (n_entries + 1,) host copy of row_ptr


def chunk_walk(pack: ChunkedSplits, device) -> ChunkWalk:
    """:class:`ChunkWalk` of ``pack`` on ``device``: each chunk's real
    pairs, stably sorted by output row."""
    q_all, slot = np.nonzero(pack.mask > 0)          # chunk-major, in order
    o = pack.out_idx[q_all, slot].astype(np.int64)
    key = q_all.astype(np.int64) * pack.n_out_rows + o
    order = np.argsort(key, kind="stable")
    key, q_all, slot = key[order], q_all[order], slot[order]
    entry_key, pair_entry = np.unique(key, return_inverse=True)
    pair_entry = pair_entry.ravel()
    row_ptr = np.searchsorted(pair_entry, np.arange(len(entry_key) + 1))
    entry_ptr = np.searchsorted(entry_key // pack.n_out_rows,
                                np.arange(pack.n_chunks + 1))

    def dev(a, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return ChunkWalk(
        pack=pack, rows=dev(entry_key % pack.n_out_rows),
        row_ptr=dev(row_ptr), pair_a=dev(pack.a_idx[q_all, slot]),
        pair_p=dev(pack.p_loc[q_all, slot]),
        pair_entry=dev(pair_entry, torch.int64),
        entry_ptr=entry_ptr.astype(np.int64),
        pair_ptr=row_ptr.astype(np.int64))


def ema_chunk_acc_plain(out: torch.Tensor, m_a: torch.Tensor,
                        y_c: torch.Tensor, walk: ChunkWalk,
                        q: int) -> torch.Tensor:
    """The plain version of the chunk-accumulate kernel, in place: chunk
    ``q``'s pairs, ``out[j] += m_a[a] * y_c[p]``, as the reference's
    pair-block scatter-adds (``index_add_``), each product and sum in f32
    and each touched output row rounded once to ``out``'s dtype."""
    e0, e1 = int(walk.entry_ptr[q]), int(walk.entry_ptr[q + 1])
    if e0 == e1:
        return out
    p0, p1 = int(walk.pair_ptr[e0]), int(walk.pair_ptr[e1])
    rows = walk.rows[e0:e1].long()
    acc = out.index_select(-2, rows).float()
    terms = (m_a.index_select(-2, walk.pair_a[p0:p1].long()).float()
             * y_c.index_select(-2, walk.pair_p[p0:p1].long()).float())
    acc.index_add_(-2, walk.pair_entry[p0:p1] - e0, terms)
    out.index_copy_(-2, rows, acc.to(out.dtype))
    return out


def ema_chunk_acc(out: torch.Tensor, m_a: torch.Tensor, y_c: torch.Tensor,
                  walk: ChunkWalk, q: int) -> torch.Tensor:
    """Add chunk ``q``'s pairs into ``out`` in place: ``(..., S, N)``
    output, ``(..., Ca, N)`` active table and the chunk's ``(..., r, N)``
    neighbor sums. The plain version on CPU tensors, one launch of
    ``csrc/ema_chunk.cu`` on CUDA tensors (none for a chunk without
    pairs)."""
    if out.device.type == "cpu":
        return ema_chunk_acc_plain(out, m_a, y_c, walk, q)
    lead, n = out.shape[:-2], out.shape[-1]
    for t in (m_a, y_c):
        if t.shape[:-2] != lead or t.shape[-1] != n:
            raise ValueError(f"chunk-accumulate tables disagree: "
                             f"{tuple(out.shape)} vs {tuple(t.shape)}")
        if t.dtype != out.dtype:
            raise TypeError(f"chunk-accumulate tables differ in dtype: "
                            f"{out.dtype}, {t.dtype}")
    for t in (out, m_a, y_c, walk.rows):
        if t.device != out.device or not t.is_contiguous():
            raise ValueError("chunk-accumulate operands must be "
                             "contiguous, on one device")
    if out.shape[-2] != walk.pack.n_out_rows:
        raise ValueError(f"output has {out.shape[-2]} rows, the pack "
                         f"{walk.pack.n_out_rows}")
    code = card_dtype_code(out.dtype)
    e0, e1 = int(walk.entry_ptr[q]), int(walk.entry_ptr[q + 1])
    if e0 == e1 or out.numel() == 0:
        return out
    batch = out.numel() // max(1, out.shape[-2] * n)
    fn = _build.kernel("rt_ema_chunk_acc", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check("ema_chunk_acc", fn(
        code, m_a.data_ptr(), y_c.data_ptr(), walk.rows.data_ptr(),
        walk.row_ptr.data_ptr(), walk.pair_a.data_ptr(),
        walk.pair_p.data_ptr(), e0, e1 - e0, m_a.shape[-2], y_c.shape[-2],
        out.shape[-2], n, batch, out.data_ptr(), stream))
    ema_chunk_acc.launches += 1
    return out


ema_chunk_acc.launches = 0


def ema_chunked(m_a: torch.Tensor, m_p: torch.Tensor, walk: ChunkWalk,
                spmm_fn) -> torch.Tensor:
    """eMA that never materializes the full passive SpMM output.

    ``spmm_fn(chunk)`` maps a ``(..., r, N)`` row chunk of the passive
    table (``spmm.ops.spmm_row_chunk``: a view at batch 1, the last chunk
    short) to its neighbor sums; each chunk's pairs are then added into one
    ``(..., C(k, t), N)`` output, allocated once. Extra device memory is
    one chunk's neighbor sums (and at batch > 1 one chunk copy) instead of
    the whole ``C(k, t_p) x N`` table. Matches the unchunked path to float
    reassociation (~1e-6 relative in f32); bf16 storage rounds each output
    row once per chunk that touches it.
    """
    from repro_torch.kernels.spmm.ops import spmm_row_chunk
    pack = walk.pack
    out = torch.zeros(m_a.shape[:-2] + (pack.n_out_rows, m_a.shape[-1]),
                      dtype=m_a.dtype, device=m_a.device)
    for q in range(pack.n_chunks):
        y_c = spmm_fn(spmm_row_chunk(m_p, q, pack.chunk_rows))
        ema_chunk_acc(out, m_a, y_c, walk, q)
    return out
