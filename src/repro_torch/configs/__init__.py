"""Architecture registry: an arch id resolves here.

A copy of the JAX package's ``configs/__init__.py``: the 10 assigned
architectures, their shape cells, and the reduced same-family configs of
the smoke tests. Every model runs from these configs
(``repro_torch.models``): the GNNs (``build_gnn``, ``build_nequip``), the
five LMs (``build_lm``) and AutoInt (``build_autoint``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import (autoint, deepseek_moe_16b, gatedgcn,
                                 gemma3_1b, graphsage_reddit, llama3_8b,
                                 nequip, pna, qwen3_moe_30b_a3b, smollm_360m)
from repro_torch.configs.base import (ArchConfig, GNNConfig, LMConfig,
                                      MoEConfig, RecsysConfig, ShapeCell)

_MODULES = (smollm_360m, llama3_8b, gemma3_1b, deepseek_moe_16b,
            qwen3_moe_30b_a3b, graphsage_reddit, pna, gatedgcn, nequip,
            autoint)

REGISTRY: dict[str, ArchConfig] = {m.CONFIG.arch_id: m.CONFIG
                                   for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def reduced_config(arch_id: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (few layers, small dims,
    few experts, small vocab/tables)."""
    arch = get_config(arch_id)
    m = arch.model
    if arch.family == "lm":
        moe = m.moe and MoEConfig(n_experts=min(8, m.moe.n_experts),
                                  top_k=min(2, m.moe.top_k),
                                  n_shared=m.moe.n_shared)
        rm = dataclasses.replace(
            m, n_layers=2 + m.first_dense_layers, d_model=64,
            n_heads=max(2, min(4, m.n_heads)),
            n_kv_heads=max(1, min(2, m.n_kv_heads)), d_ff=96,
            dense_d_ff=128 if m.dense_d_ff else None,
            vocab_size=256, d_head=16 if m.d_head else None,
            sliding_window=8 if m.sliding_window else None,
            moe=moe, param_dtype=torch.float32, remat=False)
        cells = (ShapeCell("smoke_train", "train", {"seq": 32, "batch": 2}),
                 ShapeCell("smoke_prefill", "prefill", {"seq": 48, "batch": 1}),
                 ShapeCell("smoke_decode", "decode", {"seq": 32, "batch": 2}))
    elif arch.family == "gnn":
        rm = dataclasses.replace(m, n_layers=2, d_hidden=16, n_classes=5)
        cells = (
            ShapeCell("smoke_full", "train", {"n": 40, "e": 160, "d_feat": 9}),
            ShapeCell("smoke_molecule", "train",
                      {"n": 8, "e": 16, "batch": 4, "d_feat": 6}),
        )
    else:
        rm = dataclasses.replace(m, vocab_size=64, n_attn_layers=2)
        cells = (
            ShapeCell("smoke_train", "train", {"batch": 16}),
            ShapeCell("smoke_retrieval", "retrieval",
                      {"batch": 2, "n_candidates": 128, "d_cand": 8}),
        )
    return dataclasses.replace(arch, model=rm, cells=cells)


__all__ = ["REGISTRY", "ARCH_IDS", "get_config", "reduced_config",
           "ArchConfig", "LMConfig", "GNNConfig", "RecsysConfig",
           "MoEConfig", "ShapeCell"]
