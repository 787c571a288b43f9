"""AdamW + schedules + clipping + optional int8 error-feedback gradient
compression (for a bandwidth-bound all-reduce).

A port of the JAX package's ``optim/optimizer.py``. :class:`AdamW` is a
``torch.optim.Optimizer`` whose step is the reference's ``adamw_update``:
the global-norm clip inside the step, the learning rate of the cosine
schedule at ``step + 1``, float32 moments whatever the parameter's dtype,
and the decoupled weight decay added to the update before the learning
rate scales it. :func:`compressed_psum` runs the reference's collective
over a ``torch.distributed`` process group.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = ["AdamWConfig", "AdamW", "clip_by_global_norm", "cosine_schedule",
           "compress_int8", "decompress_int8", "compressed_psum"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``, a float32 scalar tensor: linear
    warmup, then a cosine decay to 0 at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled so their global float32 norm is at most
    ``max_norm``, that norm before scaling)."""
    sq = sum((torch.sum(g.float() ** 2) for g in grads),
             torch.zeros((), dtype=torch.float32))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


class AdamW(torch.optim.Optimizer):
    """The reference's AdamW over ``params`` (or ``named_parameters()``,
    which :func:`repro_torch.interop.adamw_state_from_arrays` needs to
    load the reference's state). A parameter without a gradient steps as
    one with a zero gradient, as every leaf does in the reference. After
    each :meth:`step`, ``last_grad_norm`` and ``last_lr`` hold the
    reference's ``grad_norm`` and ``lr``."""

    def __init__(self, params, cfg: AdamWConfig = AdamWConfig()):
        super().__init__(params, {"step": 0})
        self.cfg = cfg
        self.last_grad_norm = self.last_lr = None

    def params(self) -> list:
        """The parameters in the order :meth:`step` takes ``grads``."""
        return [p for group in self.param_groups for p in group["params"]]

    def init_moments(self) -> None:
        """Zero float32 moments for every parameter that has none, as the
        reference's ``init_adamw`` makes them before the first step."""
        for p in self.params():
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p,
                                                       dtype=torch.float32)
                self.state[p]["nu"] = torch.zeros_like(p,
                                                       dtype=torch.float32)

    @torch.no_grad()
    def step(self, closure=None, *, grads=None, cfg: AdamWConfig | None
             = None):
        """One update from ``grads`` (one a parameter, in :meth:`params`'
        order, of any float dtype: the reference hands ``adamw_update``
        float32 accumulated gradients for bf16 parameters), or from each
        parameter's ``.grad`` when ``grads`` is ``None``; ``cfg`` in place
        of the optimizer's own for this step (the reference's train step
        holds the config, not its state)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        cfg = cfg or self.cfg
        params = self.params()
        step = self.param_groups[0]["step"] + 1
        for group in self.param_groups:
            group["step"] = step
        lr = cosine_schedule(cfg, step)
        t = torch.tensor(step, dtype=torch.float32)
        bc1, bc2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
        elif len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} "
                             f"parameters")
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        self.init_moments()
        for p, g in zip(params, grads):
            state = self.state[p]
            g32, p32 = g.float(), p.float()
            mu = cfg.b1 * state["mu"] + (1 - cfg.b1) * g32
            nu = cfg.b2 * state["nu"] + (1 - cfg.b2) * g32 * g32
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            delta = delta + cfg.weight_decay * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
            state["mu"], state["nu"] = mu, nu
        self.last_grad_norm, self.last_lr = gnorm, lr
        return loss


# --------------------------------------------------- gradient compression
def compress_int8(g):
    """Per-tensor symmetric int8 quantization -> (q, scale)."""
    amax = torch.max(torch.abs(g.float()))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def compressed_psum(grads, residuals, group=None):
    """Error-feedback int8-compressed gradient all-reduce over ``group``
    (the default process group when ``None``).

    Each rank quantizes (grad + residual) with a scale taken from the
    group's largest magnitude (``all_reduce(MAX)``), sums the int8
    payload in int32 (``all_reduce(SUM)``), dequantizes, and keeps the
    quantization error as next step's residual. ``grads`` and
    ``residuals`` are both lists or both dicts of tensors; -> (summed,
    new residuals) of the same kind.
    """
    keys = list(grads) if isinstance(grads, dict) else range(len(grads))
    summed, new_res = {}, {}
    for k in keys:
        x = grads[k].float() + residuals[k]
        amax = torch.max(torch.abs(x)).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax[0], min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        new_res[k] = x - q.float() * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        summed[k] = total.float() * scale
    if isinstance(grads, dict):
        return summed, new_res
    return [summed[k] for k in keys], [new_res[k] for k in keys]
