"""Tree automorphism counting via AHU canonical forms.

The final color-coding estimate divides by the automorphism count of the
template (paper Alg. 1 line 11-12). For a rooted tree,
``aut(v) = prod_children aut(c) * prod_(groups of identical child canon) g!``.
For the unrooted count we root at the tree's center; a bicentral tree with two
isomorphic halves gains an extra factor of 2.
"""

from __future__ import annotations

from collections import Counter
from math import factorial

__all__ = ["tree_automorphisms", "tree_centers", "canonical_form"]


def _adjacency(edges, k):
    adj = {v: [] for v in range(k)}
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    return adj


def tree_centers(edges, k: int) -> list[int]:
    """1 or 2 centers found by iteratively stripping leaves."""
    if k == 1:
        return [0]
    adj = _adjacency(edges, k)
    degree = {v: len(adj[v]) for v in range(k)}
    leaves = [v for v in range(k) if degree[v] <= 1]
    removed = len(leaves)
    while removed < k:
        nxt = []
        for leaf in leaves:
            degree[leaf] = 0
            for u in adj[leaf]:
                if degree[u] > 1:
                    degree[u] -= 1
                    if degree[u] == 1:
                        nxt.append(u)
        removed += len(nxt)
        leaves = nxt
    return sorted(leaves)


def _canon_and_aut(adj, v: int, parent: int) -> tuple[str, int]:
    """AHU canonical string + automorphism count of subtree rooted at v."""
    child_data = sorted(
        _canon_and_aut(adj, u, v) for u in adj[v] if u != parent
    )
    canon = "(" + "".join(c for c, _ in child_data) + ")"
    aut = 1
    for _, a in child_data:
        aut *= a
    for _, g in Counter(c for c, _ in child_data).items():
        aut *= factorial(g)
    return canon, aut


def canonical_form(edges, k: int) -> str:
    """Canonical string of the unrooted tree (rooted at center(s))."""
    centers = tree_centers(edges, k)
    adj = _adjacency(edges, k)
    forms = sorted(_canon_and_aut(adj, c, -1)[0] for c in centers)
    return "|".join(forms)


def tree_automorphisms(edges, k: int) -> int:
    """Automorphism count of an unrooted tree on k vertices."""
    if k == 1:
        return 1
    adj = _adjacency(edges, k)
    centers = tree_centers(edges, k)
    if len(centers) == 1:
        return _canon_and_aut(adj, centers[0], -1)[1]
    u, v = centers
    cu, au = _canon_and_aut(adj, u, v)
    cv, av = _canon_and_aut(adj, v, u)
    aut = au * av
    if cu == cv:  # the two halves can be swapped
        aut *= 2
    return aut
