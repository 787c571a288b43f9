"""Explicit data-parallel (DDP) training step over ``torch.distributed``,
with optional int8 error-feedback gradient compression.

A port of the JAX package's ``train/ddp.py``, whose ``shard_map`` step
runs here on every rank of a process group (or of a ``DeviceMesh``'s
``data`` dimension): each rank takes its contiguous slice of every batch
array's leading dim, as ``P(axis)`` gives it, computes its gradients, and
the group sums them, compressed 4x through
:func:`repro_torch.optim.optimizer.compressed_psum` (over the reference's
leaves: an LM's stacked layer leaf shares one int8 scale) or in full with
``all_reduce``; both are divided by the group's size, as the reference's
``pmean`` and its division after ``compressed_psum`` are. Params are
replicated; the compression residual is part of the train state (error
feedback keeps the long-run update unbiased).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.optim.optimizer import AdamWConfig, compressed_psum
from repro_torch.train.step import (_leaf, _slots, _state, grads_of,
                                    loss_fn_for)

__all__ = ["build_ddp_step", "init_ddp_state"]


def init_ddp_state(params, *, device=None) -> dict:
    """The DDP train state of a model ``params`` (an ``nn.Module``, moved
    to ``device``, CUDA unless ``"cpu"``): ``{"params", "opt",
    "residual"}``, the residual float32 zeros one a parameter name."""
    dev = resolve_device(device)
    model = params.to(dev)
    state = _state(model)
    state["residual"] = {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=dev)
                         for n, p in model.named_parameters()}
    return state


def _group(group, axis: str):
    if group is not None and hasattr(group, "get_group"):    # a DeviceMesh
        return group.get_group(axis)
    return group


def _local(x, rank: int, n: int):
    """This rank's contiguous slice of ``x``'s leading dim (scalars and
    statics whole)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} does not split over "
                         f"{n} ranks")
    rows = x.shape[0] // n
    return x[rank * rows:(rank + 1) * rows]


def _compressed_sum(model, grads: dict, residual: dict, pg):
    """``compressed_psum`` over the reference's leaves: an LM's per-block
    gradients of one stacked leaf share its int8 scale, as the reference's
    stacked leaf does. -> (summed, new residual), one a parameter name."""
    slots = _slots(model)
    summed, res = compressed_psum(
        {path: _leaf(s, grads) for path, s in slots.items()},
        {path: _leaf(s, residual) for path, s in slots.items()}, group=pg)
    out_g, out_r = {}, {}
    for path, s in slots.items():
        for name, idx in s:
            out_g[name] = summed[path] if idx is None else summed[path][idx]
            out_r[name] = res[path] if idx is None else res[path][idx]
    return out_g, out_r


def build_ddp_step(arch: ArchConfig, group=None,
                   opt_cfg: AdamWConfig | None = None,
                   statics: dict | None = None, compress: bool = True,
                   axis: str = "data"):
    """Returns ``step(state, batch) -> (state, metrics)`` over ``group``
    (a process group, the default one when ``None``, or a ``DeviceMesh``,
    whose ``axis`` dimension is taken); every rank calls it with the
    whole batch and the same state, and the state is updated in place."""
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = loss_fn_for(arch)
    statics = statics or {}

    def step(state, batch):
        pg = _group(group, axis)
        n, rank = dist.get_world_size(pg), dist.get_rank(pg)
        model, opt = state["params"], state["opt"]
        params = opt.params()
        local = {k: _local(v, rank, n) for k, v in batch.items()}
        loss, grads = grads_of(loss_fn, model, params, {**local, **statics})
        if compress:
            names = opt.param_groups[0]["param_names"]
            summed, state["residual"] = _compressed_sum(
                model, dict(zip(names, grads)), state["residual"], pg)
            grads = [summed[k] / n for k in names]
        else:
            grads = [g.contiguous() for g in grads]
            for g in grads:
                dist.all_reduce(g, group=pg)
                g.div_(n)
        loss = loss.clone()
        dist.all_reduce(loss, group=pg)
        loss.div_(n)
        opt.step(grads=grads, cfg=opt_cfg)
        metrics = {"grad_norm": opt.last_grad_norm,
                   "lr": opt.last_lr.to(loss.device), "loss": loss}
        return state, metrics

    return step
