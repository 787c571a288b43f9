"""Deterministic synthetic graph generators (host-side numpy).

RMAT matches the paper's synthetic datasets; Erdos-Renyi / Barabasi-Albert /
grids / stars cover tests and benchmarks. All generators take an integer seed
and are reproducible.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = [
    "rmat",
    "erdos_renyi",
    "barabasi_albert",
    "grid_2d",
    "star",
    "path_graph",
    "complete_graph",
    "random_regular",
]


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> Graph:
    """R-MAT generator (Chakrabarti et al. 2004); skew grows with a/(b=c=d)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << level
        dst |= go_right.astype(np.int64) << level
    return Graph.from_edges(n, np.stack([src, dst], axis=1))


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    edges = rng.integers(0, n, size=(m, 2))
    return Graph.from_edges(n, edges)


def barabasi_albert(n: int, m_attach: int = 4, seed: int = 0) -> Graph:
    """Preferential attachment (vectorized approximation via repeated targets)."""
    rng = np.random.default_rng(seed)
    repeated: list[int] = list(range(m_attach))
    edges = []
    for v in range(m_attach, n):
        # sample m_attach targets proportional to degree (with replacement ok)
        idx = rng.integers(0, len(repeated), size=m_attach)
        chosen = [repeated[i] for i in idx]
        for u in chosen:
            edges.append((v, u))
        repeated.extend(chosen)
        repeated.extend([v] * m_attach)
    return Graph.from_edges(n, np.asarray(edges, dtype=np.int64))


def grid_2d(rows: int, cols: int) -> Graph:
    idx = np.arange(rows * cols).reshape(rows, cols)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1))
    return Graph.from_edges(rows * cols, np.concatenate(e, axis=0))


def star(n: int) -> Graph:
    edges = np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], axis=1)
    return Graph.from_edges(n, edges)


def path_graph(n: int) -> Graph:
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return Graph.from_edges(n, edges)


def complete_graph(n: int) -> Graph:
    src, dst = np.meshgrid(np.arange(n), np.arange(n))
    return Graph.from_edges(n, np.stack([src.ravel(), dst.ravel()], axis=1))


def random_regular(n: int, d: int, seed: int = 0) -> Graph:
    """Approximate d-regular graph via random perfect matchings."""
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(d):
        perm = rng.permutation(n)
        edges.append(np.stack([perm[: n // 2], perm[n // 2: 2 * (n // 2)]], axis=1))
    return Graph.from_edges(n, np.concatenate(edges, axis=0))
