"""Per-family shape cells.

A copy of the cells of the JAX package's ``configs/shapes.py`` and its
``pad_to``: node and edge counts of the big GNN cells are padded to the
next multiple of 512, as the reference's input specs pad them
(:func:`repro_torch.data.synthetic.gnn_batch` pads identically).
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeCell

__all__ = ["lm_cells", "gnn_cells", "recsys_cells", "pad_to"]


def pad_to(n: int, mult: int = 512) -> int:
    return -(-n // mult) * mult


def lm_cells() -> tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
        ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
        ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
        ShapeCell("long_500k", "decode", {"seq": 524288, "batch": 1}),
    )


def gnn_cells() -> tuple[ShapeCell, ...]:
    # minibatch_lg: 1024 seeds, fanout 15-10 => 169,984 nodes / 168,960 edges
    return (
        ShapeCell("full_graph_sm", "train",
                  {"n": 2708, "e": 10556, "d_feat": 1433}),
        ShapeCell("minibatch_lg", "train",
                  {"n": 169_984, "e": 168_960, "d_feat": 602,
                   "seeds": 1024}),
        ShapeCell("ogb_products", "train",
                  {"n": 2_449_029, "e": 61_859_140, "d_feat": 100}),
        ShapeCell("molecule", "train",
                  {"n": 30, "e": 64, "batch": 128, "d_feat": 16}),
    )


def recsys_cells() -> tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_batch", "train", {"batch": 65_536}),
        ShapeCell("serve_p99", "serve", {"batch": 512}),
        ShapeCell("serve_bulk", "serve", {"batch": 262_144}),
        ShapeCell("retrieval_cand", "retrieval",
                  {"batch": 1, "n_candidates": 1 << 20, "d_cand": 64}),
    )
