"""Fused SpMM -> eMA ``out = ema(m_a, m_p @ A, IA, IP)``: the CUDA
kernels' wrappers, their plain versions, and the card's shared-memory fit
models.

The kernel (``csrc/fused_spmm_ema.cu``) keeps the ``(C(k,t_p), TV)`` slice
of the neighbor sums ``y`` of one destination tile in shared memory and
never writes ``y`` to device memory; it sums ``y`` over each block's
nonzeros (``BsrPrep.col_ptr``, ``nz_src``). :func:`fused_fits_smem` is
the model the engine admits plan nodes by, in place of the TPU's VMEM
budget (``fused_fits_vmem`` in the JAX package).

:func:`fused_spmm_ema_shared` is the group form: several consumers of ONE
passive child from one launch of ``csrc/fused_spmm_ema_shared.cu``, whose
SpMM leg walks the same nonzero index once into shared ``y`` and whose
consumers each apply their split combination to it, m_a's slice staged in
shared memory. :func:`fused_group_fits_smem` is its fit model
(``fused_group_fits_vmem`` in the JAX package).

On CPU tensors the wrappers run their plain versions; on CUDA tensors they
launch their kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_LIMIT
from repro_torch.kernels.ema.ops import ema_plain
from repro_torch.kernels.spmm.ops import BsrPrep, _check_operands, spmm_acc

__all__ = ["fused_spmm_ema", "fused_spmm_ema_plain", "fused_fits_smem",
           "fused_smem_bytes", "fused_spmm_ema_shared",
           "fused_spmm_ema_shared_plain", "fused_group_fits_smem",
           "fused_group_smem_bytes", "MAX_GROUP", "SMEM_LIMIT"]

# TV destination columns per CUDA block of both kernels, beside y[c_p][TV]
# in f32 (csrc/bsr_tile.cuh). Both keep an m_a slice in at most
# A_SLICE_BYTES beside y (csrc/bsr_sparse_tile.cuh)
TILE, TV = 128, 32
A_SLICE_BYTES = 32_768
_Y_ITEM = 4
# warps per CUDA block: the group kernel reduces a row's split partials
# across them in a WARPS x TV f32 shared buffer (which holds a chunk of
# the split table before)
WARPS = 8
# consumers one shared-passive launch takes (MAX_GROUP in the kernel)
MAX_GROUP = 16


def fused_smem_bytes(c_p: int, dtype=torch.float32) -> int:
    """Most dynamic shared memory one fused launch's CUDA block takes:
    ``y`` beside the largest m_a slice it keeps (the same for f32 and bf16
    storage; a wider m_a is read from device memory instead)."""
    return A_SLICE_BYTES + c_p * TV * _Y_ITEM


def fused_fits_smem(c_p: int, dtype=torch.float32) -> bool:
    """Whether a plan node whose passive child has ``c_p`` color sets fits
    one CUDA block (f32 or bf16 storage: c_p <= 1,560)."""
    return fused_smem_bytes(c_p, dtype) <= SMEM_LIMIT


def fused_group_smem_bytes(c_p: int, dtype=torch.float32) -> int:
    """Most dynamic shared memory one shared-passive group launch's CUDA
    block takes: the fused kernel's (the largest m_a slice it keeps beside
    ``y[c_p, TV]``, paid once for every consumer) and the split partials
    (the same for f32 and bf16 storage)."""
    return fused_smem_bytes(c_p, dtype) + WARPS * TV * _Y_ITEM


def fused_group_fits_smem(n_consumers: int, c_p: int,
                          dtype=torch.float32) -> bool:
    """Whether a group of ``n_consumers`` consumers of one passive child
    with ``c_p`` color sets runs as one launch of the group kernel."""
    return 1 <= n_consumers <= MAX_GROUP \
        and fused_group_smem_bytes(c_p, dtype) <= SMEM_LIMIT


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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m_a.device).cuda_stream
    _build.check("fused_spmm_ema", fn(
        code, m_a.data_ptr(), m_p.data_ptr(), ia.data_ptr(), ip.data_ptr(),
        s, l, c_a, c_p, n, batch, prep.src_tile.data_ptr(),
        prep.tile_ptr.data_ptr(), prep.col_ptr.data_ptr(),
        prep.nz_src.data_ptr(), prep.n_tiles, out.data_ptr(), stream))
    fused_spmm_ema.launches += 1
    return out


fused_spmm_ema.launches = 0


def fused_spmm_ema_shared_plain(m_as, m_p: torch.Tensor, ias, ips,
                                prep: BsrPrep) -> tuple:
    """The plain version of the group kernel: ONE plain SpMM kept in the
    accumulator dtype, then one plain eMA per consumer."""
    y = spmm_acc(m_p.reshape(-1, m_p.shape[-1]), prep).reshape(m_p.shape)
    return tuple(ema_plain(m_a, y, ia, ip)
                 for m_a, ia, ip in zip(m_as, ias, ips))


def fused_spmm_ema_shared(m_as, m_p: torch.Tensor, ias, ips,
                          prep: BsrPrep) -> tuple:
    """Per-consumer ``ema(m_a_i, m_p @ A, ia_i, ip_i)`` tuple for a group of
    consumers sharing the passive table ``m_p`` (tables ``(..., C, N)``
    with one shared leading batch dimension at most): the plain version on
    CPU tensors, ONE launch of the group kernel on CUDA tensors. Raises for
    more than :data:`MAX_GROUP` consumers."""
    m_as, ias, ips = tuple(m_as), tuple(ias), tuple(ips)
    if not (len(m_as) == len(ias) == len(ips)) or not m_as:
        raise ValueError("a group needs one (m_a, ia, ip) per consumer")
    if m_p.device.type == "cpu":
        return fused_spmm_ema_shared_plain(m_as, m_p, ias, ips, prep)
    if len(m_as) > MAX_GROUP:
        raise ValueError(f"{len(m_as)} consumers: the group kernel takes at "
                         f"most {MAX_GROUP}")
    code = _check_operands("fused_spmm_ema_shared", prep, m_p, *m_as)
    if m_p.dim() > 3 or any(m.shape[:-2] != m_p.shape[:-2] for m in m_as):
        raise ValueError("group tables disagree in their batch dimension")
    for ia, ip in zip(ias, ips):
        for t in (ia, ip):
            if t.device != m_p.device or not t.is_contiguous() \
                    or t.dtype != torch.int32 or t.shape != ia.shape:
                raise ValueError("split tables must be contiguous int32 "
                                 "(S, L) pairs on the tables' device")
    c_p = m_p.shape[-2]
    if not fused_group_fits_smem(len(m_as), c_p, m_p.dtype):
        raise ValueError(f"c_p={c_p} needs "
                         f"{fused_group_smem_bytes(c_p, m_p.dtype)} bytes of "
                         f"shared memory, over {SMEM_LIMIT}")
    n = prep.n
    batch = m_p.shape[0] if m_p.dim() == 3 else 1
    outs = tuple(torch.empty(m.shape[:-2] + (ia.shape[0], n), dtype=m.dtype,
                             device=m.device) for m, ia in zip(m_as, ias))
    if batch == 0 or n == 0:
        return outs
    # members whose m_a slice fits A_SLICE_BYTES are staged in shared
    # memory, the widest of them sizing the slices; the others are read
    # directly
    staged = [m.shape[-2] for m in m_as
              if m.shape[-2] * TV * m.element_size() <= A_SLICE_BYTES]
    a_rows = max(staged, default=0)
    # one int64 row per consumer: m_a, IA, IP, out, c_a, S, L, 0 (the
    # kernel's GroupMember); kept alive until the launch is enqueued
    desc = torch.tensor([[m.data_ptr(), ia.data_ptr(), ip.data_ptr(),
                          o.data_ptr(), m.shape[-2], ia.shape[0],
                          ia.shape[1], 0]
                         for m, ia, ip, o in zip(m_as, ias, ips, outs)],
                        dtype=torch.int64).to(m_p.device)
    fn = _build.kernel("rt_fused_spmm_ema_shared", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m_p.device).cuda_stream
    _build.check("fused_spmm_ema_shared", fn(
        code, m_p.data_ptr(), c_p, n, batch, a_rows, len(staged),
        prep.src_tile.data_ptr(), prep.tile_ptr.data_ptr(),
        prep.col_ptr.data_ptr(), prep.nz_src.data_ptr(), prep.n_tiles,
        desc.data_ptr(), len(m_as), stream))
    fused_spmm_ema_shared.launches += 1
    return outs


fused_spmm_ema_shared.launches = 0
