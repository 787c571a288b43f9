"""Vertex reordering for locality (paper §4.3 pre-processing).

Reverse Cuthill-McKee concentrates nonzeros near the diagonal, which on
the card means fewer occupied 128x128 BSR blocks for the BSR SpMM and the
fused kernels to walk. Degree sorting groups the hubs, for the gather
path's destination tiles.

Engines opt in with ``CountingEngine(..., reorder="rcm")``: the graph is
permuted ONCE at engine construction, the whole plan walk runs in the
permuted vertex space, and only the coloring input / root-table output are
permuted at the engine boundary (see ``core/engines.py``). Orderings are
registered in :data:`ORDERINGS` by the name the engine and API accept.

A copy of the JAX package's ``graph/reorder.py`` (numpy only): the same
graph gives the same permutation.

Conventions: an ordering is ``order[new_id] = old_id``; its inverse is
``inv[old_id] = new_id`` (``inverse_order``). A coloring permutes as
``colors[..., order]`` and a per-vertex table inverse-permutes back as
``table[..., inv]``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = ["rcm_order", "degree_order", "apply_order", "inverse_order",
           "ORDERINGS"]


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill-McKee permutation: order[new_id] = old_id."""
    n = g.n
    visited = np.zeros(n, dtype=bool)
    order: list[int] = []
    degrees = g.degrees
    # iterate components, starting from minimum-degree unvisited vertex
    remaining = np.argsort(degrees, kind="stable")
    ptr = 0
    while len(order) < n:
        while ptr < n and visited[remaining[ptr]]:
            ptr += 1
        if ptr >= n:
            break
        root = int(remaining[ptr])
        visited[root] = True
        order.append(root)
        head = len(order) - 1
        while head < len(order):
            v = order[head]
            head += 1
            nbrs = g.neighbors(v)
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(degrees[nbrs], kind="stable")]
                visited[nbrs] = True
                order.extend(int(u) for u in nbrs)
    return np.asarray(order[::-1], dtype=np.int64)


def degree_order(g: Graph) -> np.ndarray:
    """Descending degree; ties keep the reverse of their label order."""
    return np.argsort(g.degrees, kind="stable")[::-1].copy()


# name -> ordering function; the vocabulary `reorder=` accepts everywhere
# (engine constructor, repro_torch.api)
ORDERINGS = {"rcm": rcm_order, "degree": degree_order}


def inverse_order(order: np.ndarray) -> np.ndarray:
    """inv[old_id] = new_id for an ``order[new_id] = old_id`` permutation."""
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return inv


def apply_order(g: Graph, order: np.ndarray) -> Graph:
    """Relabel graph so new vertex i is old vertex order[i].

    Returns a FRESH :class:`Graph` built from the relabeled edge list — no
    cached derived state (BSR blocks, fingerprint, degree arrays, ELL pads)
    leaks across from ``g``; everything is recomputed lazily for the new
    labeling. ``order`` must be a permutation of ``range(g.n)``.
    """
    order = np.asarray(order)
    if order.shape != (g.n,) or not np.array_equal(
            np.sort(order), np.arange(g.n)):
        raise ValueError(
            f"order must be a permutation of range({g.n}), got shape "
            f"{order.shape}")
    inv = inverse_order(order)
    src, dst = g.edges_by_dst
    new_edges = np.stack([inv[src], inv[dst]], axis=1)
    return Graph.from_edges(g.n, new_edges)
