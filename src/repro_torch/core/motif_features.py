"""Per-vertex motif-count features (GSN-style) from the PGBSC engine.

The root table M_0 of the DP holds, per vertex v, the number of colorful
embeddings rooted at v. Averaged over iterations and rescaled by 1/(P·alpha)
this estimates the number of template copies touching v at the root — a
structural feature vector usable by downstream GNNs (Graph Substructure
Networks; Bouritsas et al.).

The template list runs as ONE fused-plan engine per template size k on the
``dedup`` plan, as in the JAX package's ``core/motif_features.py``: same-k
templates share a coloring stream, and canonical rooted sub-templates they
have in common are computed once per coloring, with every template's root
table a kept output of the same plan walk. Template roots that share a
passive sub-template run as one shared-passive group launch on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.colorsets import colorful_probability
from repro_torch.core.engines import CountingEngine
from repro_torch.core.templates import TemplateSpec
from repro_torch.graph.coloring import iteration_key, random_coloring
from repro_torch.graph.structure import Graph

__all__ = ["motif_features"]


def motif_features(g: Graph, templates: list, n_iters: int = 8, seed: int = 0,
                   engine: str = "pgbsc", log1p: bool = True, *,
                   memory_budget_bytes: int | None = None, dtype=None,
                   device=None) -> np.ndarray:
    """(n, len(templates)) float32 matrix of per-vertex motif count
    estimates. ``templates`` accepts registry names, :class:`TemplateSpec`,
    TreeTemplate objects, or raw edge lists, in any mix. Runs on CUDA
    unless ``device="cpu"``; the colorings of iterations ``0..n_iters-1``
    are the JAX package's, so the features match it."""
    specs = [TemplateSpec.of(t) for t in templates]
    by_k: dict[int, list[int]] = {}
    for i, s in enumerate(specs):
        by_k.setdefault(s.k, []).append(i)
    kw = {"engine": engine, "plan": "dedup", "device": device}
    if memory_budget_bytes is not None:
        kw["memory_budget_bytes"] = int(memory_budget_bytes)
    if dtype is not None:
        kw["dtype"] = dtype

    feats: list[np.ndarray | None] = [None] * len(specs)
    for k, idxs in sorted(by_k.items()):
        trees = [specs[i].tree for i in idxs]
        eng = CountingEngine(g, trees if len(trees) > 1 else trees[0], **kw)
        colors = torch.stack([
            random_coloring(iteration_key(seed, it, device=eng.device), g.n,
                            k) for it in range(n_iters)])
        _, roots = eng.count_colorful_batch(colors)
        if not eng.fused:
            roots = (roots,)
        p = colorful_probability(k)
        for j, i in enumerate(idxs):
            # (B, 1, n) root tables -> per-vertex sums over the colorings
            acc = roots[j].double().sum(dim=(0, 1)).cpu().numpy()
            feats[i] = acc / n_iters / (p * trees[j].automorphisms)
    out = np.stack(feats, axis=1).astype(np.float32)
    return np.log1p(out) if log1p else out
