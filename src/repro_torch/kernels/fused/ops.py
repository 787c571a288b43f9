"""Fused SpMM -> eMA ``out = ema(m_a, m_p @ A, IA, IP)``: the CUDA
kernel's wrapper, its plain version, and the card's shared-memory fit model.

The kernel (``csrc/fused_spmm_ema.cu``) keeps the ``(C(k,t_p), TV)`` slice
of the neighbor sums ``y`` of one destination tile in shared memory and
never writes ``y`` to device memory. :func:`fused_fits_smem` is the model
the engine admits plan nodes by, in place of the TPU's VMEM budget
(``fused_fits_vmem`` in the JAX package).

On CPU tensors :func:`fused_spmm_ema` runs :func:`fused_spmm_ema_plain`;
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import accum_dtype
from repro_torch.kernels import _build
from repro_torch.kernels.ema.ops import ema_plain
from repro_torch.kernels.spmm.ops import BsrPrep, _check_operands, spmm_acc

__all__ = ["fused_spmm_ema", "fused_spmm_ema_plain", "fused_fits_smem",
           "fused_smem_bytes", "SMEM_LIMIT"]

# the layout of csrc/bsr_tile.cuh: TV destination columns per CUDA block,
# one TILE x TV block slice and one STAGE x TILE table slice staged beside
# y[c_p][TV]; every buffer in the accumulator dtype
TILE, TV, STAGE = 128, 32, 32
# dynamic shared memory one block may have on the H100 (227 KB)
SMEM_LIMIT = 232_448


def fused_smem_bytes(c_p: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one fused launch's CUDA block."""
    item = accum_dtype(dtype).itemsize
    return (TILE * TV + STAGE * TILE + c_p * TV) * item


def fused_fits_smem(c_p: int, dtype=torch.float32) -> bool:
    """Whether a plan node whose passive child has ``c_p`` color sets fits
    one CUDA block (f32 or bf16 storage: c_p <= 1,560)."""
    return fused_smem_bytes(c_p, dtype) <= SMEM_LIMIT


def fused_spmm_ema_plain(m_a: torch.Tensor, m_p: torch.Tensor,
                         ia: torch.Tensor, ip: torch.Tensor,
                         prep: BsrPrep) -> torch.Tensor:
    """The plain PyTorch version: the plain SpMM kept in the accumulator
    dtype (the kernel's y never rounds to storage), then the plain eMA."""
    y = spmm_acc(m_p.reshape(-1, m_p.shape[-1]), prep).reshape(m_p.shape)
    return ema_plain(m_a, y, ia, ip)


def fused_spmm_ema(m_a: torch.Tensor, m_p: torch.Tensor, ia: torch.Tensor,
                   ip: torch.Tensor, prep: BsrPrep) -> torch.Tensor:
    """``ema(m_a, m_p @ A, ia, ip)`` for ``(..., C, N)`` tables (one
    leading batch dimension at most): the plain version on CPU tensors,
    one launch of the CUDA kernel on CUDA tensors."""
    if m_a.device.type == "cpu":
        return fused_spmm_ema_plain(m_a, m_p, ia, ip, prep)
    code = _check_operands("fused_spmm_ema", prep, m_a, m_p)
    if m_a.shape[:-2] != m_p.shape[:-2] or m_a.dim() > 3:
        raise ValueError(f"fused tables disagree: {tuple(m_a.shape)} vs "
                         f"{tuple(m_p.shape)}")
    for t in (ia, ip):
        if t.device != m_a.device or not t.is_contiguous() \
                or t.dtype != torch.int32 or t.shape != ia.shape:
            raise ValueError("split tables must be two contiguous int32 "
                             "(S, L) tensors on the tables' device")
    c_a, c_p = m_a.shape[-2], m_p.shape[-2]
    if not fused_fits_smem(c_p, m_p.dtype):
        raise ValueError(f"c_p={c_p} needs {fused_smem_bytes(c_p, m_p.dtype)}"
                         f" bytes of shared memory, over {SMEM_LIMIT}")
    s, l = ia.shape
    n = prep.n
    batch = m_a.shape[0] if m_a.dim() == 3 else 1
    out = torch.empty(m_a.shape[:-2] + (s, n), dtype=m_a.dtype,
                      device=m_a.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel("rt_fused_spmm_ema", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    stream = torch.cuda.current_stream(m_a.device).cuda_stream
    _build.check("fused_spmm_ema", fn(
        code, m_a.data_ptr(), m_p.data_ptr(), ia.data_ptr(), ip.data_ptr(),
        s, l, c_a, c_p, n, batch, prep.blocks.data_ptr(),
        prep.src_tile.data_ptr(), prep.tile_ptr.data_ptr(), prep.n_tiles,
        out.data_ptr(), stream))
    fused_spmm_ema.launches += 1
    return out


fused_spmm_ema.launches = 0
