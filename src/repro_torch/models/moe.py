"""Mixture-of-Experts FFN with GShard-style grouped capacity dispatch.

A port of the JAX package's ``models/moe.py``. Tokens are split into
``groups`` (the largest divisor of the token count not above the
request), and each group dispatches into its own ``(E, C, D)`` buffer
with per-group capacity ``C = max(1, int(cf * T_g * K / E))``:
overflowing (token, k) slots are dropped, and the residual stream carries
them. Queue positions come from a stable sort of the slot -> expert ids and
a running maximum of the run starts (``torch.cummax``); the dispatch
scatter-adds each group's tokens along dim 1 of ``(G, E*C + 1, D)`` (the
reference's per-group ``segment_sum``), whose extra row, the overflow bin,
is cut off afterwards, so the group dim stays a batch dim: split over the
data axes on a mesh, each rank scatters only its own groups. Each kept slot
receives exactly one token, so the sum is exact in any order. The aux
loss is Switch Transformer's, on the top-1 choice.

The router parameter stays f32 in a bf16 model, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (MLP, draw_normal, gather,
                                       mlp_swiglu, silu)

__all__ = ["MoE", "moe_ffn", "route", "pick_groups"]


class MoE(nn.Module):
    """``router`` (d, E) f32; stacked expert weights ``w_gate``/``w_up``
    (E, d, ff) and ``w_down`` (E, ff, d); ``shared`` an MLP of width
    ``ff * n_shared`` when ``n_shared``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 n_shared: int, *, dtype, device, generator):
        super().__init__()
        s = d_model ** -0.5
        kw = dict(device=device, generator=generator)
        self.router = draw_normal((d_model, n_experts), s,
                                  dtype=torch.float32, **kw)
        self.w_gate = draw_normal((n_experts, d_model, d_ff), s,
                                  dtype=dtype, **kw)
        self.w_up = draw_normal((n_experts, d_model, d_ff), s, dtype=dtype,
                                **kw)
        self.w_down = draw_normal((n_experts, d_ff, d_model), d_ff ** -0.5,
                                  dtype=dtype, **kw)
        if n_shared:
            self.shared = MLP(d_model, d_ff * n_shared, dtype=dtype, **kw)


def pick_groups(requested: int, n_tokens: int) -> int:
    """Largest divisor of n_tokens that is <= requested."""
    g = max(1, min(requested, n_tokens))
    while n_tokens % g:
        g -= 1
    return g


def route(p: MoE, xg: torch.Tensor, top_k: int):
    """Router over grouped tokens ``xg`` (G, Tg, D) -> (probs (G, Tg, E)
    f32, gate_vals (G, Tg, K) renormalised, gate_idx (G, Tg, K)). The
    top-k is a stable descending sort, so on a tie the lower expert index
    comes first, as ``jax.lax.top_k`` orders it."""
    logits = xg.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate_idx = torch.sort(probs, dim=-1, descending=True,
                          stable=True).indices[..., :top_k]
    gate_vals = gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def moe_ffn(p: MoE, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25,
            groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    b, s, d = x.shape
    e = p.router.shape[1]
    n_tokens = b * s
    g = pick_groups(groups, n_tokens)
    t_g = n_tokens // g
    xg = x.reshape(g, t_g, d)

    probs, gate_vals, gate_idx = route(p, xg, top_k)
    capacity = max(1, int(capacity_factor * t_g * top_k / e))

    # each (token, k)'s position in its expert's queue: a stable sort of
    # the slot -> expert ids, numbered within each run of equal ids
    n_slots = t_g * top_k
    ids = gate_idx.reshape(g, n_slots)
    order = torch.argsort(ids, dim=1, stable=True)
    sorted_ids = ids.gather(1, order)
    iota = torch.arange(n_slots, device=x.device).expand(g, n_slots)
    is_start = torch.ones_like(ids, dtype=torch.bool)
    is_start[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    run_start = torch.cummax(torch.where(is_start, iota, 0), dim=1).values
    # into a tensor placed as the permutation (ids may be split along the
    # slots, which a scatter along them cannot keep in place)
    pos = torch.empty_like(order).scatter_(1, order, iota - run_start)
    pos = pos.reshape(g, t_g, top_k)
    keep = pos < capacity

    # dispatch: (G, E*C + 1, D) with the overflow bin last
    slot = gate_idx * capacity + torch.clamp(pos, max=capacity - 1)
    slot = torch.where(keep, slot, e * capacity)
    xk = xg[:, :, None, :].expand(g, t_g, top_k, d).reshape(g, n_slots, d)
    at = slot.reshape(g, n_slots, 1).expand(g, n_slots, d)
    # zeros at xg's placements (the groups split alike), one slot
    # expanded: the out-of-place scatter makes the only buffer
    zeros = torch.zeros_like(xg[:, :1]).expand(g, e * capacity + 1, d)
    buf = torch.scatter_add(zeros, 1, at, xk)
    buf = buf[:, :-1].reshape(g, e, capacity, d)

    # expert compute: einsum("gecd,edf->gecf") as a batched product over E
    be = buf.transpose(0, 1).reshape(e, g * capacity, d)
    h = silu(torch.bmm(be, p.w_gate)) * torch.bmm(be, p.w_up)
    y = torch.bmm(h, p.w_down).reshape(e, g, capacity, d).transpose(0, 1)

    # combine: gather each kept slot's output, weight by its gate
    y_flat = y.reshape(g, e * capacity, d)
    take = torch.where(keep, gate_idx * capacity + pos, 0)
    gathered = gather(y_flat, 1, take.reshape(g, -1, 1).expand(-1, -1, d)
                      ).reshape(g, t_g, top_k, d)
    gathered = torch.where(keep[..., None], gathered, 0.0)
    out = (gathered * gate_vals[..., None].to(gathered.dtype)).sum(2)
    out = out.reshape(b, s, d)

    if hasattr(p, "shared"):
        out = out + mlp_swiglu(p.shared, x.reshape(n_tokens, d)
                               ).reshape(b, s, d)

    # Switch-style load-balance aux loss (global over groups)
    frac_tokens = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * mean_probs)
    return out, aux
