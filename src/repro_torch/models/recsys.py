"""AutoInt (arXiv:1810.11921): self-attentive feature interaction over
sparse field embeddings, and the EmbeddingBag it needs.

A port of the JAX package's ``models/recsys.py``. ``embedding_bag`` is the
reference's take-and-masked-reduce, not ``F.embedding_bag``: ``-1`` marks
padding, ``mean`` divides by ``max(count, 1e-6)`` and ``max`` takes an
empty bag to 0. The stacked table ``(n_sparse, V, D)`` is indexed per
field with one advanced-indexing gather. Retrieval scoring is one matmul
of the query embedding against the candidate matrix.

Parameters keep the reference's names and layout (``tables``,
``dense_proj``, ``field_proj``, ``attn`` a list of ``{wq, wk, wv, res}``,
``out``, a 0-d ``bias``) and its initial distributions, drawn on the
target device from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.layers import draw_normal

__all__ = ["embedding_bag", "AutoInt", "build_autoint", "autoint_forward",
           "autoint_loss", "retrieval_scores", "user_embedding"]


def _bag_reduce(emb, mask, weights, mode: str):
    """Reduce gathered rows ``emb`` (..., L, D) over L under ``mask``
    (..., L) and optional ``weights``."""
    m = mask[..., None].to(emb.dtype)
    if weights is not None:
        m = m * weights[..., None].to(emb.dtype)
    if mode == "sum":
        return (emb * m).sum(dim=-2)
    if mode == "mean":
        return (emb * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1e-6)
    if mode == "max":
        out = torch.where(mask[..., None], emb, float("-inf")).amax(dim=-2)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(mode)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "mean") -> torch.Tensor:
    """table (V, D); indices (B, L) with -1 padding -> (B, D)."""
    mask = indices >= 0
    safe = torch.where(mask, indices, 0).long()
    return _bag_reduce(table[safe], mask, weights, mode)


class _Interacting(nn.Module):
    def __init__(self, d_att: int, n_heads: int, **kw):
        super().__init__()
        s = d_att ** -0.5
        shape = (d_att, n_heads, d_att // n_heads)
        self.wq = draw_normal(shape, s, **kw)
        self.wk = draw_normal(shape, s, **kw)
        self.wv = draw_normal(shape, s, **kw)
        self.res = draw_normal((d_att, d_att), s, **kw)


class AutoInt(nn.Module):
    def __init__(self, cfg, *, device, generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=device, generator=generator)
        d_att = cfg.d_attn
        n_fields = cfg.n_sparse + 1      # +1 projected dense-feature field
        # one stacked table: (n_sparse, V, D)
        self.tables = draw_normal(
            (cfg.n_sparse, cfg.vocab_size, cfg.embed_dim), 0.05, **kw)
        self.dense_proj = draw_normal((cfg.n_dense, cfg.embed_dim), 0.1,
                                      **kw)
        self.field_proj = draw_normal((cfg.embed_dim, d_att),
                                      cfg.embed_dim ** -0.5, **kw)
        out = draw_normal((n_fields * d_att,), 0.01, **kw)
        self.attn = nn.ModuleList(_Interacting(d_att, cfg.n_heads, **kw)
                                  for _ in range(cfg.n_attn_layers))
        self.out = out
        self.bias = nn.Parameter(torch.zeros((), dtype=cfg.param_dtype,
                                             device=device))


def build_autoint(cfg, *, device=None, generator=None) -> AutoInt:
    """An :class:`AutoInt` of a ``RecsysConfig`` on ``device`` (CUDA
    unless ``"cpu"``), drawn there from ``generator`` (one on that device,
    seeded 0, when none is given)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return AutoInt(cfg, device=dev, generator=generator)


def _field_embeddings(model: AutoInt, batch: dict) -> torch.Tensor:
    """-> (B, n_fields, embed_dim). The leading ``bag_fields`` fields are
    multi-hot bags (mean EmbeddingBag) when the batch has ``bag_ids``."""
    cfg = model.cfg
    sparse = batch["sparse_ids"].long()           # (B, n_sparse)
    fields = torch.arange(cfg.n_sparse, device=sparse.device)
    emb = model.tables[fields, sparse]            # (B, n_sparse, D)
    bag_ids = batch.get("bag_ids")
    if cfg.bag_fields and bag_ids is not None:
        mask = bag_ids >= 0                       # (B, F_bag, L)
        safe = torch.where(mask, bag_ids, 0).long()
        rows = model.tables[fields[:cfg.bag_fields, None], safe]
        bag = _bag_reduce(rows, mask, None, "mean")   # (B, F_bag, D)
        emb = torch.cat([bag, emb[:, cfg.bag_fields:]], dim=1)
    dense = batch["dense"].to(emb.dtype)          # (B, n_dense)
    dense_field = dense @ model.dense_proj        # (B, D)
    return torch.cat([emb, dense_field[:, None, :]], dim=1)


def _interact(model: AutoInt, fields: torch.Tensor) -> torch.Tensor:
    """AutoInt interacting layers over (B, F, d_attn)."""
    h = fields
    for lp in model.attn:
        q, k, v = (torch.einsum("bfd,dhk->bfhk", h, w)
                   for w in (lp.wq, lp.wk, lp.wv))
        logits = torch.einsum("bfhk,bghk->bhfg", q, k).float()
        logits = logits * q.shape[-1] ** -0.5
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        att = torch.einsum("bhfg,bghk->bfhk", probs, v).reshape(h.shape)
        h = F.relu(att + h @ lp.res)
    return h


def user_embedding(model: AutoInt, batch: dict) -> torch.Tensor:
    """(B, n_fields * d_attn) representation (retrieval tower)."""
    h = _field_embeddings(model, batch) @ model.field_proj
    h = _interact(model, h)
    return h.reshape(h.shape[0], -1)


def autoint_forward(model: AutoInt, batch: dict) -> torch.Tensor:
    """-> (B,) CTR logits, f32."""
    rep = user_embedding(model, batch)
    return (rep @ model.out + model.bias).float()


def autoint_loss(model: AutoInt, batch: dict) -> torch.Tensor:
    """The stable binary cross entropy of the CTR logits."""
    logits = autoint_forward(model, batch)
    y = batch["labels"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def retrieval_scores(model: AutoInt, batch: dict, candidates: torch.Tensor,
                     proj: torch.Tensor) -> torch.Tensor:
    """Score one (or a few) queries against ``(n_cand, d_c)`` candidate
    embeddings: one matmul."""
    rep = user_embedding(model, batch) @ proj       # (B, d_c)
    return rep @ candidates.T                       # (B, n_cand)
