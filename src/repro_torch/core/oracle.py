"""Brute-force oracles for correctness validation (host-side, small graphs).

Two ground truths:

* ``count_embeddings`` — the number of injective edge-preserving maps of the
  template T into G ("labeled embeddings"). The number of *subgraphs of G
  isomorphic to T* is this divided by aut(T).
* ``count_colorful_embeddings`` — labeled embeddings whose image vertices all
  have distinct colors under a fixed coloring. This equals
  ``sum_v sum_C M_0`` produced by the DP for the same coloring, exactly.

A numpy copy of the JAX package's ``core/oracle.py``; the tests hold every
engine of the port against it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.templates import TreeTemplate
from repro_torch.graph.structure import Graph

__all__ = [
    "count_embeddings",
    "count_colorful_embeddings",
    "count_subgraphs_exact",
]


def _embed(g: Graph, t: TreeTemplate, accept) -> int:
    """Count injective homomorphisms T -> G, filtered by ``accept(mapping)``.

    Template vertices are assigned in BFS order from the template root so each
    newly placed vertex has exactly one already-placed neighbor (tree).
    """
    order = [t.root]
    parent = {t.root: -1}
    for v in order:
        for u in t.adjacency(v):
            if u not in parent:
                parent[u] = v
                order.append(u)
    assert len(order) == t.k

    count = 0
    mapping = np.full(t.k, -1, dtype=np.int64)
    used = np.zeros(g.n, dtype=bool)

    def rec(pos: int) -> None:
        nonlocal count
        if pos == t.k:
            count += 1 if accept(mapping) else 0
            return
        tv = order[pos]
        if parent[tv] < 0:
            candidates = range(g.n)
        else:
            candidates = g.neighbors(int(mapping[parent[tv]]))
        for gv in candidates:
            gv = int(gv)
            if not used[gv]:
                used[gv] = True
                mapping[tv] = gv
                rec(pos + 1)
                used[gv] = False
                mapping[tv] = -1

    rec(0)
    return count


def count_embeddings(g: Graph, t: TreeTemplate) -> int:
    return _embed(g, t, lambda m: True)


def count_colorful_embeddings(g: Graph, t: TreeTemplate,
                              colors: np.ndarray) -> int:
    colors = np.asarray(colors)

    def accept(mapping):
        cs = colors[mapping]
        return len(set(cs.tolist())) == t.k

    return _embed(g, t, accept)


def count_subgraphs_exact(g: Graph, t: TreeTemplate) -> float:
    """Exact number of subgraphs of G isomorphic to T."""
    return count_embeddings(g, t) / t.automorphisms
