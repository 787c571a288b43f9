"""Decoder-only transformer LM covering all five registered LM
architectures.

A port of the JAX package's ``models/transformer.py``: GQA + RoPE,
optional sliding-window local attention with every Nth layer global
(gemma3 5:1), optional QK-norm (qwen3), optional MoE FFN with shared
experts (deepseek, qwen3) and leading dense layers (deepseek), optional
activation checkpointing, and KV-cache decode with chunked prefill.

The reference stacks its scanned layers' parameters along a leading axis
and runs them under ``lax.scan``; the port holds them as ``LM.layers``, an
``nn.ModuleList`` run in a Python loop, and ``LM.dense_front`` likewise
(``repro_torch.interop.lm_from_params`` unstacks the reference's
``layers`` leaves into it, ``params_to_arrays`` restacks them).
``LMConfig.scan_layers`` has no meaning in eager torch and is ignored;
``remat`` becomes ``torch.utils.checkpoint`` of each block, only when
autograd records.

The decode cache is a dict ``{"k", "v", "k_front", "v_front", "len"}``
whose K/V tensors are ``(n_layers, B, S_max, Hkv, Dh)``;
``lm_prefill_chunked`` and ``lm_decode_step`` write it in place and return
the same dict, where the reference returns a new one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, moe_ffn

__all__ = ["Block", "LM", "build_lm", "lm_forward", "lm_loss",
           "init_decode_cache", "decode_cache_on", "lm_decode_step",
           "lm_prefill", "lm_prefill_chunked", "layer_is_global",
           "window_flags"]


def layer_is_global(cfg, idx: int) -> bool:
    if cfg.sliding_window is None:
        return True
    if cfg.global_every <= 0:
        return False
    return (idx + 1) % cfg.global_every == 0


def _n_front(cfg) -> int:
    return cfg.first_dense_layers if cfg.moe else 0


def window_flags(cfg, n: int) -> list[float]:
    """Per-scanned-layer flag: 1.0 = global attention, 0.0 = windowed;
    the scanned layers' indices start after the dense front."""
    offset = _n_front(cfg)
    return [1.0 if layer_is_global(cfg, offset + i) else 0.0
            for i in range(n)]


class Block(nn.Module):
    """One transformer block: ``attn``, ``ln1``, ``ln2`` and either ``moe``
    or ``mlp`` (of width ``dense_d_ff`` or ``d_ff``)."""

    def __init__(self, cfg, moe_layer: bool, *, device, generator):
        super().__init__()
        self.cfg = cfg
        dt = cfg.param_dtype
        kw = dict(dtype=dt, device=device, generator=generator)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, use_qk_norm=cfg.use_qk_norm,
                                **kw)
        self.ln1 = L.RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.ln2 = L.RMSNorm(cfg.d_model, dtype=dt, device=device)
        if moe_layer:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.moe.n_experts,
                           cfg.moe.n_shared, **kw)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.dense_d_ff or cfg.d_ff, **kw)

    def _attn_kw(self, window: bool = True) -> dict:
        c = self.cfg
        return dict(n_heads=c.n_heads, n_kv=c.n_kv_heads, d_head=c.head_dim,
                    theta=c.rope_theta, use_qk_norm=c.use_qk_norm,
                    window=c.sliding_window if window else None)

    def ffn(self, hn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The block's FFN on normed input -> (out, aux)."""
        if hasattr(self, "moe"):
            m = self.cfg.moe
            return moe_ffn(self.moe, hn, top_k=m.top_k,
                           capacity_factor=m.capacity_factor,
                           groups=m.groups)
        return L.mlp_swiglu(self.mlp, hn), hn.new_zeros((),
                                                        dtype=torch.float32)

    def _ffn_residual(self, x, h):
        """``x + h``, then the FFN on its norm and the second residual ->
        (out, aux). The sum ``x + h`` stays f32 until the block's end, as
        XLA keeps it at default precision (its bf16 rounding is elided:
        the sum feeds only the f32 norm and the f32 add), so a bf16 block
        rounds once, at its output."""
        xs = x.float() + h.float()
        f, aux = self.ffn(L.rms_norm(self.ln2, xs, self.cfg.norm_eps
                                     ).to(x.dtype))
        return (xs + f.float()).to(x.dtype), aux

    def forward(self, x, is_global, q_chunk: int = 1024,
                kv_chunk: int = 1024):
        """-> (x, aux_loss). The local/global mix is the layer's flag
        folded into the attention mask."""
        c = self.cfg
        h = L.attention(self.attn, L.rms_norm(self.ln1, x, c.norm_eps),
                        is_global=is_global, q_chunk=q_chunk,
                        kv_chunk=kv_chunk, unroll_chunks=c.attn_unroll,
                        **self._attn_kw())
        return self._ffn_residual(x, h)

    def prefill(self, x, cache_k, cache_v, c0: int, is_global):
        """One block over a prompt chunk at offset c0: writes the chunk's
        K/V into the cache and attends to the whole prefix."""
        c = self.cfg
        h, _, _ = L.prefill_attention(
            self.attn, L.rms_norm(self.ln1, x, c.norm_eps), cache_k, cache_v,
            c0, is_global=is_global, **self._attn_kw())
        return self._ffn_residual(x, h)[0]

    def decode(self, x, cache_k, cache_v, cache_len, is_global, *,
               window: bool = True):
        """One decode step of the block; ``window=False`` drops the window
        (the dense front, as in the reference)."""
        c = self.cfg
        h, _, _ = L.decode_attention(
            self.attn, L.rms_norm(self.ln1, x, c.norm_eps), cache_k, cache_v,
            cache_len, is_global=is_global, **self._attn_kw(window))
        return self._ffn_residual(x, h)[0]


class LM(nn.Module):
    """``embed`` (V, d), ``lm_head`` (d, V), ``ln_f``, the scanned
    ``layers`` and the ``dense_front``, drawn in the reference's order
    (scanned layers, dense front, embedding, head)."""

    def __init__(self, cfg, *, device, generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        n_front = _n_front(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.moe is not None, **kw)
            for _ in range(cfg.n_layers - n_front))
        self.dense_front = nn.ModuleList(Block(cfg, False, **kw)
                                         for _ in range(n_front))
        s = cfg.d_model ** -0.5
        dt = cfg.param_dtype
        self.embed = L.draw_normal((cfg.vocab_size, cfg.d_model), s,
                                   dtype=dt, **kw)
        self.lm_head = L.draw_normal((cfg.d_model, cfg.vocab_size), s,
                                     dtype=dt, **kw)
        self.ln_f = L.RMSNorm(cfg.d_model, dtype=dt, device=device)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the f32 logits."""
        x = L.rms_norm(self.ln_f, x, self.cfg.norm_eps)
        return (x @ self.lm_head).float()


def build_lm(cfg, *, device=None, generator=None) -> LM:
    """An :class:`LM` of ``cfg`` on ``device`` (CUDA unless ``"cpu"``),
    its parameters drawn there from ``generator`` (one on that device,
    seeded 0, when none is given)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return LM(cfg, device=dev, generator=generator)


def lm_forward(model: LM, tokens: torch.Tensor, *, q_chunk: int = 1024,
               kv_chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) f32, aux_loss). Attention runs
    full up to ``max(q_chunk, kv_chunk)`` tokens, blocked beyond (the
    reference's 1024 by default). The embedding lookup is ``F.embedding``,
    whose backward sums a repeated token's rows in a fixed order on the
    CPU (an indexed gather's adds in any order)."""
    cfg = model.cfg
    x = L.settle(F.embedding(tokens.long(), model.embed))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    blocks = [(b, 1.0) for b in model.dense_front] + list(zip(
        model.layers, window_flags(cfg, len(model.layers))))
    for block, flag in blocks:
        if remat:
            x, aux = checkpoint(block, x, flag, q_chunk, kv_chunk,
                                use_reentrant=False)
        else:
            x, aux = block(x, flag, q_chunk, kv_chunk)
        aux_total = aux_total + aux
    return model.head(x), aux_total


def lm_loss(model: LM, tokens: torch.Tensor, targets: torch.Tensor,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Cross entropy as logsumexp minus the target's logit (the one-hot
    contraction of the reference, taken as a gather: the same value and
    gradient), plus ``aux_weight`` times the MoE aux loss."""
    logits, aux = lm_forward(model, tokens)
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = L.settle(
        logits.gather(-1, targets.long()[..., None]))[..., 0]
    return (lse - tgt_logit).mean() + aux_weight * aux


# ------------------------------------------------------------------ serving
def init_decode_cache(cfg, batch: int, s_max: int, dtype=torch.bfloat16, *,
                      device=None) -> dict:
    """Layer-stacked KV cache ``(n_layers, B, S_max, Hkv, Dh)`` for the
    scanned layers (``k``, ``v``) and the dense front (``k_front``,
    ``v_front``), and ``len`` (0-d int32). The dtype defaults to bf16
    whatever the parameters' dtype, as in the reference. Gemma3's windowed
    layers keep a full-length cache too."""
    return decode_cache_on(cfg, batch, s_max, dtype, resolve_device(device))


def decode_cache_on(cfg, batch: int, s_max: int, dtype,
                    dev: torch.device) -> dict:
    """:func:`init_decode_cache` on a device as given, unresolved: the
    meta device of the input specs allocates nothing."""
    front = _n_front(cfg)
    shape = (cfg.n_layers - front, batch, s_max, cfg.n_kv_heads,
             cfg.head_dim)
    fshape = (front,) + shape[1:]
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "k_front": torch.zeros(fshape, dtype=dtype, device=dev),
            "v_front": torch.zeros(fshape, dtype=dtype, device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def lm_decode_step(model: LM, cache: dict, token: torch.Tensor,
                   shard_hints: dict | None = None
                   ) -> tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, V) f32, cache). The cache is written
    in place at ``cache["len"]``, which is then advanced, and the same dict
    is returned. The dense front attends without a window.
    ``shard_hints`` is accepted and ignored (one card; see
    :func:`~repro_torch.models.layers.decode_attention`)."""
    cfg = model.cfg
    x = L.settle(F.embedding(token.long(), model.embed))
    cache_len = cache["len"]
    for i, block in enumerate(model.dense_front):
        x = block.decode(x, cache["k_front"][i], cache["v_front"][i],
                         cache_len, None, window=False)
    flags = window_flags(cfg, len(model.layers))
    for i, block in enumerate(model.layers):
        x = block.decode(x, cache["k"][i], cache["v"][i], cache_len,
                         flags[i])
    cache["len"] = cache_len + 1
    return model.head(x), cache


def lm_prefill(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill forward: the logits only, no cache fill."""
    return lm_forward(model, tokens)[0]


def lm_prefill_chunked(model: LM, tokens: torch.Tensor, cache: dict,
                       chunk: int = 1024) -> tuple[torch.Tensor, dict]:
    """Chunked prefill (Sarathi-style): the prompt in sequence chunks,
    each filling the KV cache (in place) and attending to the prefix, so
    attention memory is O(chunk x prefix). Returns (the last chunk's
    logits, cache) with ``len`` = S; the cache hands off to
    :func:`lm_decode_step`."""
    cfg = model.cfg
    b, s = tokens.shape
    if s % chunk:
        raise ValueError(f"prompt length {s} is not a multiple of chunk "
                         f"{chunk}")
    flags = window_flags(cfg, len(model.layers))
    for c0 in range(0, s, chunk):
        x = L.settle(F.embedding(tokens[:, c0:c0 + chunk].long(),
                                 model.embed))
        for i, block in enumerate(model.dense_front):
            x = block.prefill(x, cache["k_front"][i], cache["v_front"][i],
                              c0, 1.0)
        for i, block in enumerate(model.layers):
            x = block.prefill(x, cache["k"][i], cache["v"][i], c0, flags[i])
    cache["len"] = torch.full((), s, dtype=torch.int32,
                              device=cache["len"].device)
    return model.head(x), cache
