"""Deterministic synthetic batches: LM tokens, GNN graphs, recsys ids.

A port of the JAX package's ``data/synthetic.py``, drawn with numpy from a
seed. GNN batches: random graphs of a shape cell's node and edge counts
(batched molecules with positions for the molecule cells), drawn from the
seed the reference draws from its key (``int(jax.random.randint(key, (),
0, 1 << 30))``), so both packages make the same arrays; node and edge
counts of the big cells (n >= 100,000) are padded to a multiple of 512, as
the reference's input specs pad them. LM and recsys batches follow the
reference's distributions (``u**3 * vocab`` tokens; uniform ids, ``-1``
bag padding, gaussian dense features, Bernoulli(0.3) labels), not its key
stream: the reference draws them from JAX keys, which numpy cannot
follow.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import pad_to
from repro_torch.device import resolve_device

__all__ = ["gnn_batch", "lm_token_stream", "lm_batch", "recsys_batch"]

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


def _token_array(rng, batch: int, seq: int, vocab: int) -> np.ndarray:
    u = rng.random((batch, seq), dtype=np.float32)
    return np.clip((u ** 3 * vocab).astype(np.int32), 0, vocab - 1)


def lm_token_stream(seed: int, batch: int, seq: int, vocab: int, *,
                    device=None) -> torch.Tensor:
    """Zipf-flavoured token ids (uniform cubed concentrates mass on low
    ids), int32 ``(batch, seq)`` on ``device``."""
    dev = resolve_device(device)
    return torch.from_numpy(_token_array(np.random.default_rng(seed), batch,
                                         seq, vocab)).to(dev)


def lm_batch(arch: ArchConfig, cell_name: str, seed: int, *,
             device=None) -> dict:
    """An LM cell's batch: ``tokens`` and ``targets`` (shifted by one) for
    train, ``tokens`` for prefill, and for decode one ``token`` with a
    decode cache in the parameter dtype whose ``len`` is half the cell's
    sequence (half the window already decoded)."""
    from repro_torch.models.transformer import init_decode_cache
    if arch.family != "lm":
        raise ValueError(f"{arch.arch_id} is not an LM architecture")
    dev = resolve_device(device)
    cell = arch.cell(cell_name)
    m = arch.model
    b, s = cell.dims["batch"], cell.dims["seq"]
    if cell.kind == "train":
        toks = lm_token_stream(seed, b, s + 1, m.vocab_size, device=dev)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cell.kind == "prefill":
        return {"tokens": lm_token_stream(seed, b, s, m.vocab_size,
                                          device=dev)}
    cache = init_decode_cache(m, b, s, dtype=m.param_dtype, device=dev)
    cache["len"].fill_(s // 2)
    return {"token": lm_token_stream(seed, b, 1, m.vocab_size, device=dev),
            "cache": cache}


def recsys_batch(arch: ArchConfig, cell_name: str, seed: int, *,
                 device=None) -> dict:
    """A recsys cell's batch: ``sparse_ids`` in ``[0, V)``, ``bag_ids`` in
    ``[-1, V)`` (``-1`` pads), gaussian ``dense``; ``labels`` (Bernoulli
    0.3) for train; ``candidates`` and ``retrieval_proj`` (x 0.05) for
    retrieval."""
    if arch.family != "recsys":
        raise ValueError(f"{arch.arch_id} is not a recsys architecture")
    dev = resolve_device(device)
    cell = arch.cell(cell_name)
    m = arch.model
    b = cell.dims["batch"]
    rng = np.random.default_rng(seed)
    arrays = {
        "sparse_ids": rng.integers(0, m.vocab_size, (b, m.n_sparse),
                                   dtype=np.int32),
        "bag_ids": rng.integers(-1, m.vocab_size,
                                (b, m.bag_fields, m.bag_size),
                                dtype=np.int32),
        "dense": rng.standard_normal((b, m.n_dense), dtype=np.float32),
    }
    if cell.kind == "train":
        arrays["labels"] = (rng.random(b) < 0.3).astype(np.float32)
    if cell.kind == "retrieval":
        nc, dc = cell.dims["n_candidates"], cell.dims["d_cand"]
        n_fields = m.n_sparse + 1
        arrays["candidates"] = rng.standard_normal((nc, dc),
                                                   dtype=np.float32)
        arrays["retrieval_proj"] = rng.standard_normal(
            (n_fields * m.d_attn, dc), dtype=np.float32) * np.float32(0.05)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
