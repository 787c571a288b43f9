"""The port's graph IO (``repro_torch.graph.io``) against the JAX
package's: the edge-list text files and the ``.npz`` cache are the same
bytes, so either package loads what the other wrote, with the same
``Graph.fingerprint``."""

import os

import numpy as np
import pytest

from repro.graph import generators as ref_gen
from repro.graph import io as ref_io
from repro_torch.graph import generators
from repro_torch.graph.io import (load_cached, load_edge_list,
                                  load_graph_npz, save_edge_list,
                                  save_graph_npz)


def _same(a, b):
    assert a.n == b.n and a.fingerprint == b.fingerprint
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("maker", ["er", "grid", "rmat"])
def test_edge_list_text_is_the_reference_bytes(tmp_path, maker):
    g, rg = {"er": lambda: (generators.erdos_renyi(60, 5.0, seed=2),
                            ref_gen.erdos_renyi(60, 5.0, seed=2)),
             "grid": lambda: (generators.grid_2d(7, 9),
                              ref_gen.grid_2d(7, 9)),
             "rmat": lambda: (generators.rmat(8, 8, seed=1),
                              ref_gen.rmat(8, 8, seed=1))}[maker]()
    save_edge_list(g, str(tmp_path / "port.txt"))
    ref_io.save_edge_list(rg, str(tmp_path / "ref.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()
    got = load_edge_list(str(tmp_path / "ref.txt"))
    _same(got, ref_io.load_edge_list(str(tmp_path / "port.txt")))
    # the count is inferred: vertices past the largest id are isolated
    assert got.m == g.m and got.n <= g.n
    np.testing.assert_array_equal(got.indptr, g.indptr[:got.n + 1])
    np.testing.assert_array_equal(got.indices, g.indices)


def test_npz_is_the_reference_bytes_and_loads_across(tmp_path):
    g = generators.erdos_renyi(50, 4.0, seed=3)
    rg = ref_gen.erdos_renyi(50, 4.0, seed=3)
    save_graph_npz(g, str(tmp_path / "port.npz"))
    ref_io.save_graph_npz(rg, str(tmp_path / "ref.npz"))
    assert (tmp_path / "port.npz").read_bytes() == \
        (tmp_path / "ref.npz").read_bytes()
    _same(load_graph_npz(str(tmp_path / "ref.npz")), g)
    _same(ref_io.load_graph_npz(str(tmp_path / "port.npz")), rg)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_written_by_one_package_serves_the_other(tmp_path, writer):
    g = generators.erdos_renyi(40, 4.0, seed=4)
    p = str(tmp_path / "g.txt")
    save_edge_list(g, p)
    first, second = (ref_io.load_cached, load_cached) \
        if writer == "reference" else (load_cached, ref_io.load_cached)
    first(p)
    cache = p + ".cache.npz"
    mtime = os.path.getmtime(cache)
    got = second(p)                    # a hit: the cache is not rewritten
    assert os.path.getmtime(cache) == mtime
    assert got.fingerprint == g.fingerprint


def test_cached_loader(tmp_path):
    g = generators.erdos_renyi(40, 4.0, seed=4)
    p = str(tmp_path / "g.txt")
    save_edge_list(g, p)
    g1 = load_cached(p)
    cache = p + ".cache.npz"
    mtime = os.path.getmtime(cache)
    g2 = load_cached(p)
    assert os.path.getmtime(cache) == mtime
    _same(g1, g2)
    assert g1.m == g.m


def test_comments_and_blank_lines(tmp_path):
    p = str(tmp_path / "g.txt")
    with open(p, "w") as f:
        f.write("# header\n\n0 1\n1 2\n# trailing\n")
    g = load_edge_list(p)
    assert g.n == 3 and g.m == 4


def test_cached_loader_invalidates_on_source_rewrite(tmp_path):
    g = generators.erdos_renyi(40, 4.0, seed=4)
    p = str(tmp_path / "g.txt")
    save_edge_list(g, p)
    assert load_cached(p).fingerprint == g.fingerprint
    g2 = generators.erdos_renyi(40, 4.0, seed=7)
    save_edge_list(g2, p)
    cache = p + ".cache.npz"
    os.utime(cache, (os.path.getmtime(p) + 100,) * 2)
    assert load_cached(p).fingerprint == g2.fingerprint
    mtime = os.path.getmtime(cache)
    assert load_cached(p).fingerprint == g2.fingerprint
    assert os.path.getmtime(cache) == mtime


def test_cached_loader_rebuilds_corrupt_cache(tmp_path):
    g = generators.erdos_renyi(30, 3.0, seed=2)
    p = str(tmp_path / "g.txt")
    save_edge_list(g, p)
    cache = p + ".cache.npz"
    with open(cache, "wb") as f:
        f.write(b"PK\x03\x04 not a real zip")
    os.utime(cache, (os.path.getmtime(p) + 100,) * 2)
    assert load_cached(p).fingerprint == g.fingerprint
    assert load_graph_npz(cache).fingerprint == g.fingerprint


def test_npz_records_fingerprint_and_source(tmp_path):
    g = generators.erdos_renyi(30, 3.0, seed=1)
    src = str(tmp_path / "g.txt")
    save_edge_list(g, src)
    p = str(tmp_path / "g.npz")
    save_graph_npz(g, p, source=src)
    z = np.load(p)
    assert str(z["fingerprint"]) == g.fingerprint
    assert int(z["src_size"]) == os.path.getsize(src)
    assert load_graph_npz(p).fingerprint == g.fingerprint
