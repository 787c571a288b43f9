"""BSR SpMM ``Y = M @ A``: the CUDA kernel's wrapper and its plain version.

``prepare(graph)`` lifts the adjacency into the destination-sorted stream of
dense 128x128 {0,1} blocks (``Graph.bsr``) on a device, plus the
per-destination-tile run pointer ``tile_ptr`` the CUDA kernels walk.
``spmm(m, prep)`` applies ``Y = M @ A`` to a ``(..., C, N)`` table with the
leading (batch) dimensions folded into rows — one launch for a whole
coloring batch, as in the JAX package's ``kernels/spmm/ops.py``.

On a CPU tensor :func:`spmm` runs :func:`spmm_plain`; on a CUDA tensor it
launches ``csrc/spmm_bsr.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.device import accum_dtype, card_dtype_code, resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.kernels import _build

__all__ = ["BsrPrep", "prepare", "from_arrays", "spmm", "spmm_plain"]

# elements of the plain version's gathered (rows, blocks, tile) operand per
# chunk: bounds its working memory at full graph size
_PLAIN_CHUNK_ELEMS = 1 << 27
# block edge the CUDA kernels are compiled for (TILE in csrc/bsr_tile.cuh)
_KERNEL_TILE = 128


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

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype


def from_arrays(n: int, blocks, src_tile, dst_tile, *,
                dtype=torch.float32, device=None) -> BsrPrep:
    """A prep from the block stream as arrays (numpy or torch); builds the
    run pointer from the sorted ``dst_tile``. ``device=None`` is CUDA."""
    device = resolve_device(device)
    dst_np = np.array(dst_tile, np.int32)     # a writable copy for torch
    if np.any(np.diff(dst_np) < 0):
        raise ValueError("dst_tile must be sorted ascending")
    blocks = torch.as_tensor(blocks)
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
        tile=tile, n_tiles=n_tiles)


def prepare(g: Graph, *, dtype=torch.float32, device=None,
            tile: int = 128) -> BsrPrep:
    """The BSR operand of ``g`` in storage dtype ``dtype`` on ``device``
    (``None`` is CUDA). The blocks are densified where they live, from the
    edges' slots, so the host never holds the dense stream."""
    device = resolve_device(device)
    lay = g.padded(tile).bsr_layout(tile)
    blocks = torch.zeros((lay.n_blocks, tile, tile), dtype=dtype,
                         device=device)
    idx = [torch.as_tensor(a, device=device)
           for a in (lay.edge_block, lay.edge_src, lay.edge_dst)]
    blocks[idx[0], idx[1], idx[2]] = 1
    return from_arrays(g.n, blocks, lay.src_tile, lay.dst_tile,
                       dtype=dtype, device=device)


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


def spmm(m: torch.Tensor, prep: BsrPrep) -> torch.Tensor:
    """``Y = M @ A`` for a ``(..., C, N)`` table: the plain version on a
    CPU tensor, one launch of the CUDA kernel on a CUDA tensor."""
    if m.device.type == "cpu":
        return spmm_plain(m, prep)
    code = _check_operands("spmm", prep, m)
    rows = m.numel() // max(1, m.shape[-1])
    out = torch.empty_like(m)
    if rows == 0 or prep.n == 0:
        return out.zero_()
    fn = _build.kernel("rt_spmm_bsr", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m.device).cuda_stream
    _build.check("spmm", fn(
        code, m.data_ptr(), rows, prep.n, prep.blocks.data_ptr(),
        prep.src_tile.data_ptr(), prep.tile_ptr.data_ptr(), prep.n_tiles,
        out.data_ptr(), stream))
    spmm.launches += 1
    return out


spmm.launches = 0
