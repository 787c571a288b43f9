"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full /
blocked flash-style / sliding-window / decode-with-cache), SwiGLU MLP.

A port of the JAX package's ``models/layers.py``. Parameters live in
``nn.Module``s whose attribute names are the reference's dict keys
(``Attention.wq`` is ``params["wq"]``, ``RMSNorm.scale`` is
``params["scale"]``), at its layouts: ``wq`` ``(d_model, n_heads,
d_head)``, ``wo`` ``(n_heads, d_head, d_model)``, ``w_gate``
``(d_model, d_ff)``. The functions take those modules where the
reference takes the dicts, and keep its math and its casts: the attention
logits are contracted in the parameter dtype and then taken to f32, the
mask is an additive ``-1e30``, and the probabilities are cast to the
value dtype before the PV product. No library attention kernel runs here:
a fused one changes those casts.

Initial values follow the reference's distributions (``normal *
d_model**-0.5``, ones for the norms), drawn in f32 on the target device
from an explicit ``torch.Generator`` and then cast, never built on the host
and copied.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "rms_norm", "RMSNorm", "rope", "Attention", "attention",
    "decode_attention", "prefill_attention", "MLP", "mlp_swiglu", "silu",
    "draw_normal",
]

_NEG_INF = -1e30


def draw_normal(shape, scale: float, *, dtype, device, generator):
    """``normal(shape) * scale`` drawn in f32 on ``device`` from
    ``generator`` (which must live there), cast to ``dtype``, as a
    parameter."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    w.mul_(scale)
    return nn.Parameter(w.to(dtype))


# ---------------------------------------------------------------- lookups
def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with any pending reduction applied. A lookup into a table
    sharded along its rows (a vocab-sharded embedding on a DTensor mesh)
    leaves each rank a masked partial sum, which DTensor can reduce only
    once, while a lookup's output feeds several ops (a norm and the
    residual): it is reduced here, by adding 0 (not a linear op, so
    DTensor all-reduces first; the gradient passes as it is, where a
    ``redistribute``'s backward cannot go back to the masked partial). A
    plain tensor, or a DTensor with no pending reduction, comes back as
    it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x + 0
    return x


def write_rows_(cache: torch.Tensor, dim: int, at: torch.Tensor,
                new: torch.Tensor) -> torch.Tensor:
    """``cache.index_copy_(dim, at, new)``, in place. On a DTensor cache
    split along ``dim`` (a sequence-sharded decode cache) each rank writes
    the rows of ``at`` that fall in its own shard and writes back what it
    holds elsewhere, as XLA writes a ``dynamic_update_slice`` into a
    sharded dim: DTensor's own ``index_copy_`` would re-place the cache
    and leave its shards as they were. A plain tensor takes
    ``index_copy_`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    split = isinstance(cache, DTensor) and any(
        isinstance(p, Shard) and p.dim == dim for p in cache.placements)
    if not split:
        cache.index_copy_(dim, at, new)
        return cache
    mesh, places = cache.device_mesh, cache.placements
    local = cache.to_local()
    # this rank's first row along dim (split in mesh order)
    coord, lo, size = mesh.get_coordinate(), 0, cache.shape[dim]
    for i, p in enumerate(places):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            lo += coord[i] * size
    rows = local.shape[dim]
    new_local = new.redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in places]).to_local()
    if isinstance(at, DTensor):
        at = at.full_tensor()
    at = at - lo
    own = ((at >= 0) & (at < rows)).reshape(
        [-1 if d == dim else 1 for d in range(local.dim())])
    at = at.clamp(0, rows - 1)
    local.index_copy_(dim, at, torch.where(
        own, new_local, local.index_select(dim, at)))
    return cache


# --------------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(dtype)


# ---------------------------------------------------------------------- rope
def _rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / torch.pow(theta, exps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Pairs are
    interleaved (``x[..., 0::2]`` with ``x[..., 1::2]``), as in the
    reference, not split in halves."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., :, None, None].float() * freqs     # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, d_head: int, *,
                 dtype, device, generator, use_qk_norm: bool = False):
        super().__init__()
        s = d_model ** -0.5
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = draw_normal((d_model, n_heads, d_head), s, **kw)
        self.wk = draw_normal((d_model, n_kv, d_head), s, **kw)
        self.wv = draw_normal((d_model, n_kv, d_head), s, **kw)
        self.wo = draw_normal((n_heads, d_head, d_model), s, **kw)
        if use_qk_norm:
            self.q_norm = RMSNorm(d_head, dtype=dtype, device=device)
            self.k_norm = RMSNorm(d_head, dtype=dtype, device=device)


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(out, wo):
    """einsum("bqhk,hkd->bqd", out, wo), in the promoted dtype."""
    dt = torch.promote_types(out.dtype, wo.dtype)
    return out.flatten(-2).to(dt) @ wo.reshape(-1, wo.shape[-1]).to(dt)


def _qkv(p: Attention, x, positions, theta, use_qk_norm):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if use_qk_norm:
        q = rms_norm(p.q_norm, q)
        k = rms_norm(p.k_norm, k)
    return rope(q, positions, theta), rope(k, positions, theta), v


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D) by repetition (GQA)."""
    return k if groups == 1 else torch.repeat_interleave(k, groups, dim=2)


def _mask_ok(qpos, kpos, window: int | None, is_global):
    """Boolean keep-mask: causal, optionally windowed. ``is_global`` (a
    layer's flag, > 0.5 lifts the window) lets a layer stack mix local and
    global layers (gemma3 5:1); ``None`` keeps the window."""
    ok = kpos <= qpos
    if window is not None:
        in_window = kpos > qpos - window
        if is_global is None:
            ok = ok & in_window
        elif not is_global > 0.5:
            ok = ok & in_window
    return ok


def _additive(ok) -> torch.Tensor:
    return torch.where(ok, 0.0, _NEG_INF)


def attention(p: Attention, x: torch.Tensor, *, n_heads: int, n_kv: int,
              d_head: int, theta: float = 10_000.0,
              window: int | None = None, is_global=None,
              use_qk_norm: bool = False,
              q_chunk: int = 1024, kv_chunk: int = 1024,
              unroll_chunks: bool = False) -> torch.Tensor:
    """Causal self-attention over (B, S, D): full when ``S <=
    max(q_chunk, kv_chunk)``, else blocked online softmax (memory
    O(chunk^2)); ``unroll_chunks`` runs the reference's S/4-block
    variant."""
    b, s, d = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, positions, theta, use_qk_norm)
    groups = n_heads // n_kv
    k = _expand_kv(k, groups)
    v = _expand_kv(v, groups)
    scale = d_head ** -0.5

    if s <= max(q_chunk, kv_chunk) and not unroll_chunks:
        # einsum("bqhk,bshk->bhqs") in the parameter dtype, then f32
        logits = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)).float()
        pos = torch.arange(s, device=x.device)
        ok = _mask_ok(pos[:, None], pos[None, :], window, is_global)
        logits = logits * scale + _additive(ok)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (probs @ v.transpose(1, 2)).transpose(1, 2)
    elif unroll_chunks:
        # the reference's S/4-square blocks; with no padding the blocked
        # loop does exactly their work
        c = min(max(s // 4, 128), s)
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
        out = _blocked_attention(q, k, v, scale, window, is_global, c, c)
    else:
        out = _blocked_attention(q, k, v, scale, window, is_global,
                                 q_chunk, kv_chunk)
    return _out_proj(out, p.wo)


def _online_block(state, q_blk, k_blk, v_blk, ok, scale):
    """One kv block of the online softmax; ``state`` is (m, l, acc)."""
    m, l, acc = state
    logits = (q_blk.transpose(1, 2) @ k_blk.permute(0, 2, 3, 1)).float() \
        * scale
    logits = logits + _additive(ok)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    pr = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + pr.sum(dim=-1)
    acc_new = acc * alpha[..., None] + pr @ v_blk.float().transpose(1, 2)
    return m_new, l_new, acc_new


def _online_init(b, h, rows, dh, device):
    return (torch.full((b, h, rows), _NEG_INF, device=device),
            torch.zeros((b, h, rows), device=device),
            torch.zeros((b, h, rows, dh), device=device))


def _online_out(state):
    m, l, acc = state
    return (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2)


def _blocked_attention(q, k, v, scale, window, is_global, q_chunk, kv_chunk):
    """Online-softmax two-level blocking; causal (+ optional window). q
    and kv are padded to chunk multiples and ``kpos < s`` masks the kv
    padding, as in the reference. A kv block wholly above a q block's
    diagonal is skipped: there every logit is ``-1e30``, so the reference's
    update leaves (m, l, acc) exactly as they were."""
    b, s, h, dh = q.shape
    nq, nk = -(-s // q_chunk), -(-s // kv_chunk)
    q = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - s))
    k = F.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - s))
    v = F.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - s))
    qa = torch.arange(q_chunk, device=q.device)
    ka = torch.arange(kv_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        q_off = qi * q_chunk
        q_blk = q[:, q_off:q_off + q_chunk]
        state = _online_init(b, h, q_chunk, dh, q.device)
        for ki in range(nk):
            k_off = ki * kv_chunk
            if k_off > q_off + q_chunk - 1:
                break
            kpos = k_off + ka[None, :]
            ok = _mask_ok(q_off + qa[:, None], kpos, window, is_global) \
                & (kpos < s)
            state = _online_block(state, q_blk,
                                  k[:, k_off:k_off + kv_chunk],
                                  v[:, k_off:k_off + kv_chunk], ok, scale)
        outs.append(_online_out(state))
    return torch.cat(outs, dim=1)[:, :s].to(v.dtype)


def _grouped_logits(q, kk, n_kv, d_head):
    """einsum("bqhgk,bshk->bhgqs") of q (B, Q, H, Dh) grouped by kv head,
    in the promoted dtype, then f32."""
    b, nq, _, dh = q.shape
    dt = torch.promote_types(q.dtype, kk.dtype)
    qg = q.reshape(b, nq, n_kv, -1, dh).permute(0, 2, 3, 1, 4).to(dt)
    return (qg @ kk.permute(0, 2, 3, 1)[:, :, None].to(dt)).float()


def _grouped_values(probs, vv, n_heads):
    """einsum("bhgqs,bshk->bqhgk") -> (B, Q, H, Dh); probs are in vv's
    dtype."""
    out = probs @ vv.transpose(1, 2)[:, :, None]      # (B, Hkv, G, Q, Dh)
    b, _, _, nq, dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, nq, n_heads, dh)


def decode_attention(p: Attention, x: torch.Tensor, cache_k, cache_v,
                     cache_len, *, n_heads: int, n_kv: int, d_head: int,
                     theta: float = 10_000.0, window: int | None = None,
                     is_global=None, use_qk_norm: bool = False,
                     shard_hints: dict | None = None):
    """One-token decode. x: (B, 1, D); cache_[kv]: (B, S_max, Hkv, Dh);
    cache_len: a 0-d integer tensor (or int), the position written.

    Returns (out (B, 1, D), cache_k, cache_v): the new K/V row is written
    into ``cache_k``/``cache_v`` in place at ``cache_len`` (clamped to the
    last row, as ``dynamic_update_slice`` clamps), and the same tensors are
    returned. The query heads are grouped by kv head; the cache is never
    repeated. Softmax over the cache axis in f32; positions past
    ``cache_len`` masked. ``shard_hints`` (the reference's sharding
    constraints for a sequence-sharded cache) has no meaning on one card:
    it is accepted and ignored.
    """
    b = x.shape[0]
    s_max = cache_k.shape[1]
    cache_len = torch.as_tensor(cache_len, device=x.device)
    positions = cache_len.reshape(1, 1).expand(b, 1)
    q, k_new, v_new = _qkv(p, x, positions, theta, use_qk_norm)

    at = cache_len.clamp(0, s_max - 1).reshape(1).long()
    write_rows_(cache_k, 1, at, k_new.to(cache_k.dtype))
    write_rows_(cache_v, 1, at, v_new.to(cache_v.dtype))

    logits = _grouped_logits(q, cache_k, n_kv, d_head) * d_head ** -0.5
    kpos = torch.arange(s_max, device=x.device)
    ok = _mask_ok(cache_len, kpos, window, is_global)
    logits = torch.where(ok, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
    out = _grouped_values(probs, cache_v, n_heads)
    return _out_proj(out, p.wo), cache_k, cache_v


def prefill_attention(p: Attention, x: torch.Tensor, cache_k, cache_v,
                      c0: int, *, n_heads: int, n_kv: int, d_head: int,
                      theta: float = 10_000.0, window: int | None = None,
                      is_global=None, use_qk_norm: bool = False):
    """Chunked-prefill attention: x is the prompt chunk at offset c0; the
    chunk's K/V are written into the cache in place, and the chunk attends
    causally over cache[:, :c0+chunk]. Returns (out, cache_k, cache_v)."""
    b, cs, d = x.shape
    if c0 + cs > cache_k.shape[1]:
        raise ValueError(f"chunk [{c0}, {c0 + cs}) runs past the cache's "
                         f"{cache_k.shape[1]} rows")
    pos = c0 + torch.arange(cs, device=x.device)
    q, k_new, v_new = _qkv(p, x, pos[None, :], theta, use_qk_norm)

    cache_k[:, c0:c0 + cs] = k_new.to(cache_k.dtype)
    cache_v[:, c0:c0 + cs] = v_new.to(cache_v.dtype)

    prefix = c0 + cs
    kk, vv = cache_k[:, :prefix], cache_v[:, :prefix]
    logits = _grouped_logits(q, kk, n_kv, d_head)
    logits.mul_(d_head ** -0.5)
    ok = _mask_ok(pos[:, None], torch.arange(prefix, device=x.device)[None],
                  window, is_global)
    logits.add_(_additive(ok))
    probs = torch.softmax(logits, dim=-1).to(vv.dtype)
    del logits
    out = _grouped_values(probs, vv, n_heads)
    return _out_proj(out, p.wo), cache_k, cache_v


# ----------------------------------------------------------------------- mlp
class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype, device, generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_gate = draw_normal((d_model, d_ff), d_model ** -0.5, **kw)
        self.w_up = draw_normal((d_model, d_ff), d_model ** -0.5, **kw)
        self.w_down = draw_normal((d_ff, d_model), d_ff ** -0.5, **kw)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA runs it: ``x * (1 / (1 + exp(-x)))``, each
    op rounded to ``x``'s dtype. In bf16 this is up to one ulp from
    ``F.silu``, which rounds once."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_swiglu(p: MLP, x: torch.Tensor) -> torch.Tensor:
    gate = silu(x @ p.w_gate)
    return (gate * (x @ p.w_up)) @ p.w_down
