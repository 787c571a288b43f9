"""GNN architectures: GraphSAGE, PNA, GatedGCN (+ NequIP in equivariant.py).

A port of the JAX package's ``models/gnn.py`` to ``nn.Module``s. Message
passing gathers rows with ``index_select`` and sums them with
``index_add`` over a (2, E) edge_index, as the reference does with
``jax.ops.segment_sum``/``segment_max``: torch's own ops, on the card
unless the model was built on the CPU. Inputs come in the reference's
GraphBatch dict:

    x           (N, F) node features
    edge_index  (2, E) int32 or int64 [src; dst]
    edge_attr   (E, Fe) or absent
    node_graph  (N,) graph id for batched small graphs (else zeros)
    n_graphs    int
    pool        bool: pool node states per graph (regression)
    labels      (N,) int node labels or (n_graphs,) regression targets
    label_mask  (N,) float, optional

Parameters keep the reference's layout — a dense layer holds ``w`` of
shape ``(d_in, d_out)`` and ``b``, applied as ``x @ w + b`` — and its
initial distributions (``normal * d_in**-0.5``, zero biases), drawn from
an explicit ``torch.Generator``; ``repro_torch.interop.gnn_from_params``
loads the reference's own parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

__all__ = ["segment_sum", "segment_mean", "segment_std", "segment_max",
           "segment_min", "Dense", "GNN", "build_gnn", "gnn_forward",
           "gnn_loss"]


# ------------------------------------------------------------ segment utils
class _SegmentSum(torch.autograd.Function):
    """``index_add`` whose backward keeps only the segment ids: autograd's
    own ``index_add`` keeps its source, which for a gathered ``(E, d)``
    message is the largest tensor of a GNN step."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return data.new_zeros((num_segments,) + tuple(data.shape[1:])) \
            .index_add_(0, segment_ids, data)

    @staticmethod
    def backward(ctx, grad):
        (segment_ids,) = ctx.saved_tensors
        return grad.index_select(0, segment_ids), None, None


def segment_sum(data, segment_ids, num_segments: int):
    return _SegmentSum.apply(data, segment_ids, num_segments)


def segment_counts(segment_ids, num_segments: int) -> torch.Tensor:
    """Rows per segment, int64 (``bincount`` with ``minlength`` of ids
    below ``num_segments``), as an ``index_add_`` of ones: its output's
    shape does not depend on the ids' values, which a traced step
    (``analysis/hlo``) needs."""
    return torch.zeros(num_segments, dtype=torch.int64,
                       device=segment_ids.device).index_add_(
        0, segment_ids, torch.ones_like(segment_ids, dtype=torch.int64))


def _counts(segment_ids, num_segments: int, like):
    """Rows per segment, at least 1, shaped to broadcast over ``like``."""
    c = segment_counts(segment_ids, num_segments).clamp_min(1)
    return c.to(like.dtype).reshape((num_segments,) + (1,) * (like.dim() - 1))


def segment_mean(data, segment_ids, num_segments: int):
    return segment_sum(data, segment_ids, num_segments) / _counts(
        segment_ids, num_segments, data)


def segment_std(data, segment_ids, num_segments: int, eps: float = 1e-5):
    mean = segment_mean(data, segment_ids, num_segments)
    sq = segment_mean(data * data, segment_ids, num_segments)
    # the clamp comes before the eps, as in the reference: its gradient
    # is 0 wherever rounding leaves sq below mean**2
    return torch.sqrt(torch.clamp(sq - mean * mean, min=0.0) + eps)


def segment_max(data, segment_ids, num_segments: int):
    """Per-segment max over rows; an empty segment gives 0 (the reference
    takes ``jax.ops.segment_max``'s ``-inf`` there to 0), and no gradient
    reaches it. Tied rows share the gradient, as in JAX."""
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    mx = out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                            include_self=True)
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def segment_min(data, segment_ids, num_segments: int):
    return -segment_max(-data, segment_ids, num_segments)


# ------------------------------------------------------------------ layers
def _normal(shape, scale: float, *, dtype, device, generator):
    if torch.device(device).type == "meta":   # an abstract model: no draw
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    w = torch.randn(shape, generator=generator, device=generator.device)
    return nn.Parameter((w * scale).to(device=device, dtype=dtype))


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, *, dtype, device, generator):
        super().__init__()
        self.w = _normal((d_in, d_out), d_in ** -0.5, dtype=dtype,
                         device=device, generator=generator)
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))

    def forward(self, x):
        return x @ self.w + self.b


class _SageLayer(nn.Module):
    def __init__(self, d_in, d_out, **kw):
        super().__init__()
        # "self_" holds the reference's "self" dense layer
        self.self_ = Dense(d_in, d_out, **kw)
        self.nbr = Dense(d_in, d_out, **kw)

    def forward(self, x, src, dst):
        agg = segment_mean(x.index_select(0, src), dst, x.shape[0])
        h = F.relu(self.self_(x) + self.nbr(agg))
        # L2 normalize (GraphSAGE §3.1): h / max(|h|, 1e-6)
        return F.normalize(h, dim=-1, eps=1e-6)


_PNA_DEGREE_EPS = 1.0


class _PnaLayer(nn.Module):
    # 4 aggregators x 3 scalers = 12 concatenated views + self
    def __init__(self, d_in, d_out, **kw):
        super().__init__()
        self.pre = Dense(2 * d_in, d_in, **kw)
        self.post = Dense(13 * d_in, d_out, **kw)

    def forward(self, x, src, dst, deg, mean_log_deg):
        n = x.shape[0]
        msg = F.relu(self.pre(torch.cat([x.index_select(0, src),
                                         x.index_select(0, dst)], dim=-1)))
        aggs = [segment_mean(msg, dst, n), segment_max(msg, dst, n),
                segment_min(msg, dst, n), segment_std(msg, dst, n)]
        logd = torch.log(deg + _PNA_DEGREE_EPS)
        amp = logd / mean_log_deg
        att = torch.where(logd > 0, mean_log_deg / torch.clamp(logd, min=1e-6),
                          torch.zeros_like(logd))
        views = []
        for a in aggs:
            views.extend([a, a * amp, a * att])
        return F.relu(self.post(torch.cat([x] + views, dim=-1)))


class _Norm(nn.Module):
    """Layer-norm gain ``g`` and bias ``b``."""

    def __init__(self, d, *, dtype, device, generator):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x):
        # population variance, eps inside the rsqrt, as the reference's
        return F.layer_norm(x, (x.shape[-1],), self.g, self.b, eps=1e-5)


class _GatedLayer(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        for c in "UVABC":
            setattr(self, c, Dense(d, d, **kw))
        self.ln_h = _Norm(d, **kw)
        self.ln_e = _Norm(d, **kw)

    def forward(self, x, e, src, dst):
        e_new = self.A(x).index_select(0, src) \
            + self.B(x).index_select(0, dst) + self.C(e)
        gate = torch.sigmoid(e_new)
        num = segment_sum(gate * self.V(x).index_select(0, src), dst,
                          x.shape[0])
        den = segment_sum(gate, dst, x.shape[0])
        h_new = self.U(x) + num / (den + 1e-6)
        x = x + F.relu(self.ln_h(h_new))
        e = e + F.relu(self.ln_e(e_new))
        return x, e


_LAYERS = {"graphsage": lambda d, kw: _SageLayer(d, d, **kw),
           "pna": lambda d, kw: _PnaLayer(d, d, **kw),
           "gatedgcn": lambda d, kw: _GatedLayer(d, **kw)}


# ------------------------------------------------------------------- models
class GNN(nn.Module):
    """A GraphSAGE, PNA or GatedGCN model of a ``GNNConfig``: an input
    embedding, ``cfg.n_layers`` message-passing layers and an output
    layer; GatedGCN adds an edge embedding for ``edge_attr``."""

    def __init__(self, cfg, d_in: int, *, device, generator):
        super().__init__()
        if cfg.kind not in _LAYERS:
            raise ValueError(cfg.kind)
        self.cfg = cfg
        d = cfg.d_hidden
        kw = dict(dtype=cfg.param_dtype, device=device, generator=generator)
        self.embed = Dense(d_in, d, **kw)
        self.out = Dense(d, cfg.n_classes, **kw)
        self.layers = nn.ModuleList(_LAYERS[cfg.kind](d, kw)
                                    for _ in range(cfg.n_layers))
        if cfg.kind == "gatedgcn":
            self.edge_embed = Dense(d_in, d, **kw)

    def forward(self, batch: dict):
        """-> (N, n_classes) node logits, or (n_graphs, n_classes) if
        pooling."""
        x = batch["x"].to(self.cfg.param_dtype)
        src, dst = batch["edge_index"]
        n = x.shape[0]
        h = F.relu(self.embed(x))
        kind = self.cfg.kind
        if kind == "graphsage":
            for layer in self.layers:
                h = layer(h, src, dst)
        elif kind == "pna":
            deg = segment_counts(dst, n).to(torch.float32)[:, None]
            mean_log_deg = torch.log(deg + _PNA_DEGREE_EPS).mean()
            for layer in self.layers:
                h = layer(h, src, dst, deg, mean_log_deg)
        else:
            if batch.get("edge_attr") is not None:
                ea = batch["edge_attr"].to(self.cfg.param_dtype)
                d_in = self.edge_embed.w.shape[0]
                if ea.shape[-1] < d_in:
                    ea = F.pad(ea, (0, d_in - ea.shape[-1]))
                e = self.edge_embed(ea[:, :d_in])
            else:
                e = h.index_select(0, src) + h.index_select(0, dst)
            for layer in self.layers:
                h, e = layer(h, e, src, dst)
        if batch.get("pool", False):
            h = segment_mean(h, batch["node_graph"], batch["n_graphs"])
        return self.out(h)


def build_gnn(cfg, d_in: int, *, device=None, generator=None) -> GNN:
    """A :class:`GNN` of ``cfg`` (kind graphsage, pna or gatedgcn) on
    ``device`` (CUDA unless ``"cpu"``). Its parameters are drawn on the
    generator's device (a CPU generator seeded 0 when none is given), so
    one generator seed gives the same model on the card and on the CPU."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return GNN(cfg, d_in, device=dev, generator=generator)


def gnn_forward(model: GNN, batch: dict):
    return model(batch)


def gnn_loss(model: GNN, batch: dict):
    """Pooled: the mean squared error of the first output; else the node
    cross entropy in float32, averaged over ``label_mask`` when given."""
    logits = gnn_forward(model, batch)
    if batch.get("pool", False):
        # graph-level regression (molecule cells)
        target = batch["labels"].to(logits.dtype)
        return torch.mean((logits[:, 0] - target) ** 2)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
    mask = batch.get("label_mask")
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
