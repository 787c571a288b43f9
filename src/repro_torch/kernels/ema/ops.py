"""eMA ``out[j] = sum_l m_a[IA[j, l]] * y_p[IP[j, l]]``: the CUDA kernel's
wrapper and its plain version (paper Algorithm 4 line 7).

Tables are ``(C, N)`` or batched ``(B, C, N)``; a batch is one launch.
bf16 storage accumulates in f32 and rounds once, at the store — the
storage/accumulator contract of the JAX package's ``kernels/ema/ops.py``.
On a CPU tensor :func:`ema` runs :func:`ema_plain`; on a CUDA tensor it
launches ``csrc/ema.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import accum_dtype, card_dtype_code
from repro_torch.kernels import _build

__all__ = ["ema", "ema_plain"]

# elements of one (batch, rows, N) accumulator block of the plain version
_PLAIN_CHUNK_ELEMS = 1 << 27


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


def ema(m_a: torch.Tensor, y_p: torch.Tensor, ia: torch.Tensor,
        ip: torch.Tensor) -> torch.Tensor:
    """eMA of ``(..., Ca, N)`` and ``(..., Cp, N)`` tables with ``(S, L)``
    int32 split tables: the plain version on CPU tensors, one launch of the
    CUDA kernel on CUDA tensors."""
    if m_a.device.type == "cpu":
        return ema_plain(m_a, y_p, ia, ip)
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
    code = card_dtype_code(m_a.dtype)
    s, l = ia.shape
    n = m_a.shape[-1]
    batch = m_a.numel() // max(1, m_a.shape[-2] * n)
    out = torch.empty(m_a.shape[:-2] + (s, n), dtype=m_a.dtype,
                      device=m_a.device)
    if out.numel() == 0:
        return out
    # the staged path's split table: two terms' row offsets to an int4
    pairs = torch.empty(s * ((l + 1) // 2) * 4, dtype=torch.int32,
                        device=m_a.device)
    fn = _build.kernel("rt_ema", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    stream = torch.cuda.current_stream(m_a.device).cuda_stream
    _build.check("ema", fn(
        code, m_a.data_ptr(), y_p.data_ptr(), ia.data_ptr(), ip.data_ptr(),
        s, l, m_a.shape[-2], y_p.shape[-2], n, batch, pairs.data_ptr(),
        out.data_ptr(), stream))
    ema.launches += 1
    return out


ema.launches = 0
