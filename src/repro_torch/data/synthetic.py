"""Deterministic synthetic GNN batches.

The GNN half of the JAX package's ``data/synthetic.py``: random graphs of
a shape cell's node and edge counts (batched molecules with positions
for the molecule cells), drawn with numpy from the seed the reference
draws from its key (``int(jax.random.randint(key, (), 0, 1 << 30))``),
so both packages make the same arrays. Node and edge counts of the big
cells (n >= 100,000) are padded to a multiple of 512, as the reference's
input specs pad them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import pad_to
from repro_torch.device import resolve_device

__all__ = ["gnn_batch"]

_MOLECULE_CELLS = ("molecule", "smoke_molecule")


def gnn_batch(arch: ArchConfig, cell_name: str, seed: int, *,
              device=None) -> dict:
    """The reference's GNN batch of ``arch`` at ``cell_name`` as tensors on
    ``device`` (CUDA unless ``"cpu"``), with its statics ``pool`` and
    ``n_graphs`` beside the arrays."""
    if arch.family != "gnn":
        raise ValueError(f"{arch.arch_id} is not a GNN architecture")
    dev = resolve_device(device)
    m = arch.model
    d = arch.cell(cell_name).dims
    rng = np.random.default_rng(seed)
    if cell_name in _MOLECULE_CELLS:
        n_per, e_per, bs = d["n"], d["e"], d["batch"]
        n = n_per * bs
        src = rng.integers(0, n_per, (bs, e_per)) + \
            (np.arange(bs) * n_per)[:, None]
        dst = rng.integers(0, n_per, (bs, e_per)) + \
            (np.arange(bs) * n_per)[:, None]
        edge_index = np.stack([src.ravel(), dst.ravel()]).astype(np.int32)
        node_graph = np.repeat(np.arange(bs), n_per).astype(np.int32)
        pooled, n_graphs = True, bs
    else:
        n, e = d["n"], d["e"]
        if n >= 100_000:            # sharded cells: padded for the mesh
            n, e = pad_to(n), pad_to(e)
        edge_index = rng.integers(0, n, (2, e)).astype(np.int32)
        node_graph = np.zeros(n, np.int32)
        pooled, n_graphs = False, 1

    arrays = {"edge_index": edge_index, "node_graph": node_graph}
    if m.kind == "nequip":
        arrays["positions"] = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
        arrays["species"] = rng.integers(0, 8, n).astype(np.int32)
        arrays["labels"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    else:
        arrays["x"] = rng.normal(size=(n, d["d_feat"])).astype(np.float32)
        if pooled:
            arrays["labels"] = rng.normal(size=(n_graphs,)).astype(np.float32)
        else:
            arrays["labels"] = rng.integers(0, m.n_classes, n).astype(np.int32)
            mask = np.zeros(n, np.float32)
            mask[: max(1, n // 4)] = 1.0
            arrays["label_mask"] = mask
    batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    batch.update(pool=pooled, n_graphs=n_graphs)
    return batch
