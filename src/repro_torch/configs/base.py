"""Config dataclasses for the assigned architectures.

A copy of the JAX package's ``configs/base.py`` with ``param_dtype`` a
``torch.dtype``. Every architecture id maps to an ArchConfig with its
model config and its four input-shape cells (the assigned (arch x shape)
grid); smoke tests build *reduced* configs via
:func:`repro_torch.configs.reduced_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["MoEConfig", "LMConfig", "GNNConfig", "RecsysConfig",
           "ShapeCell", "ArchConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    groups: int = 1   # GShard dispatch groups; = data-shard count at scale


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None            # default d_model // n_heads
    moe: MoEConfig | None = None
    first_dense_layers: int = 0          # leading dense-FFN layers (deepseek)
    dense_d_ff: int | None = None        # FFN width of those layers
    sliding_window: int | None = None    # local-attention window (gemma3)
    global_every: int = 0                # every Nth layer is global (gemma3 6)
    use_qk_norm: bool = False            # qwen3
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    param_dtype: Any = torch.bfloat16
    # memory/compile knobs
    remat: bool = True
    scan_layers: bool = True
    attn_unroll: bool = False   # dry-run: python-loop attention chunks

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * dh * d
        if self.moe:
            ff_moe = 3 * d * self.d_ff * (self.moe.n_experts
                                          + self.moe.n_shared)
            router = d * self.moe.n_experts
            n_moe = self.n_layers - self.first_dense_layers
            ff_total = n_moe * (ff_moe + router) + self.first_dense_layers * \
                3 * d * (self.dense_d_ff or self.d_ff)
        else:
            ff_total = self.n_layers * 3 * d * self.d_ff
        norms = self.n_layers * 2 * d + d
        return (self.n_layers * attn + ff_total + norms
                + 2 * self.vocab_size * d)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * self.head_dim * d
        ff_active = 3 * d * self.d_ff * (self.moe.top_k + self.moe.n_shared)
        n_moe = self.n_layers - self.first_dense_layers
        ff_total = n_moe * (ff_active + d * self.moe.n_experts) + \
            self.first_dense_layers * 3 * d * (self.dense_d_ff or self.d_ff)
        return (self.n_layers * attn + ff_total + 2 * self.vocab_size * d)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                    # graphsage | pna | gatedgcn | nequip
    n_layers: int
    d_hidden: int
    extras: tuple = ()           # kind-specific (key, value) pairs
    n_classes: int = 64
    param_dtype: Any = torch.float32

    def extra(self, key, default=None):
        return dict(self.extras).get(key, default)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int = 39
    n_dense: int = 13
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    vocab_size: int = 1_000_000   # rows per sparse table
    bag_fields: int = 2           # leading fields are multi-hot bags
    bag_size: int = 8             # nnz per bag (padded)
    mlp_dims: tuple = (256, 128)
    param_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) grid cell."""

    name: str
    kind: str        # train | prefill | decode | serve
    dims: dict

    def __repr__(self):
        return f"ShapeCell({self.name}, {self.kind}, {self.dims})"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str      # lm | gnn | recsys | pgbsc
    model: Any
    cells: tuple[ShapeCell, ...]
    notes: str = ""

    def cell(self, name: str) -> ShapeCell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"{self.arch_id} has no shape cell {name!r}; "
                       f"have {[c.name for c in self.cells]}")
