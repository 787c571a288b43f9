"""Graph IO: edge-list text/binary formats + deterministic dataset cache
(a copy of the JAX package's ``graph/io.py``; numpy only, and the ``.npz``
files are the same bytes, so either package loads the other's cache).

Production ingestion path for real datasets (SNAP/Graph500 edge lists): a
text/tsv reader, a compact .npz binary cache (10-50x faster to reload), and
a helper that round-trips through the cache automatically.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = ["load_edge_list", "save_edge_list", "save_graph_npz",
           "load_graph_npz", "load_cached"]


def load_edge_list(path: str) -> Graph:
    """Whitespace-separated 'src dst' lines, '#' comments skipped; the
    vertex count is the largest id + 1. (The JAX package's ``comment=`` and
    ``n=`` options are left out: nothing in the port sets them.)"""
    edges = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            parts = s.split()
            edges.append((int(parts[0]), int(parts[1])))
    arr = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    n = int(arr.max()) + 1 if arr.size else 0
    return Graph.from_edges(n, arr)


def save_edge_list(g: Graph, path: str) -> None:
    src, dst = g.edges_by_dst
    keep = src < dst          # write each undirected edge once
    with open(path, "w") as f:
        f.write(f"# n={g.n} m={int(keep.sum())}\n")
        for s, d in zip(src[keep], dst[keep]):
            f.write(f"{s} {d}\n")


def save_graph_npz(g: Graph, path: str, *, source: str | None = None,
                   source_stat: os.stat_result | None = None) -> None:
    """Save a graph; ``source`` records the originating edge-list file's
    stat so a cache can detect staleness even when mtimes lie (copied
    caches, rewrites that preserve timestamps, coarse filesystem clocks).
    Pass ``source_stat`` captured *before* reading the source to avoid
    stamping a concurrently-rewritten file's stat onto stale content."""
    extra = {"fingerprint": np.array(g.fingerprint)}
    if source is not None:
        st = source_stat if source_stat is not None else os.stat(source)
        extra["src_mtime_ns"] = np.int64(st.st_mtime_ns)
        extra["src_size"] = np.int64(st.st_size)
    np.savez_compressed(path, n=np.int64(g.n), indptr=g.indptr,
                        indices=g.indices, **extra)


def load_graph_npz(path: str) -> Graph:
    z = np.load(path)
    return Graph(n=int(z["n"]), indptr=z["indptr"], indices=z["indices"])


def _cache_is_fresh(cache: str, path: str) -> bool:
    """A cache is fresh only if its recorded source stat matches the source
    file exactly; legacy caches without the stat fall back to mtime order."""
    if not os.path.isfile(cache):
        return False
    try:
        z = np.load(cache)
    except (OSError, ValueError, zipfile.BadZipFile):
        # unreadable/truncated/corrupt cache -> treat as stale, rebuild
        return False
    st = os.stat(path)
    if "src_mtime_ns" in z.files and "src_size" in z.files:
        return (int(z["src_mtime_ns"]) == st.st_mtime_ns
                and int(z["src_size"]) == st.st_size)
    return os.path.getmtime(cache) >= os.path.getmtime(path)


def load_cached(path: str, cache_dir: str | None = None) -> Graph:
    """Load an edge list with a transparent .npz binary cache.

    The cache records the source file's (mtime_ns, size); a rewritten or
    newer edge list invalidates it and the graph is re-parsed and re-cached.
    """
    cache_dir = cache_dir or os.path.dirname(path)
    cache = os.path.join(cache_dir,
                         os.path.basename(path) + ".cache.npz")
    if _cache_is_fresh(cache, path):
        return load_graph_npz(cache)
    # stat BEFORE parsing: if the source is rewritten mid-parse, the stamped
    # stat stays older than the file's and the cache reads as stale next time
    st = os.stat(path)
    g = load_edge_list(path)
    tmp = cache[:-len(".npz")] + ".tmp.npz"
    save_graph_npz(g, tmp, source=path, source_stat=st)
    os.replace(tmp, cache)
    return g
