"""Vertex reordering: the port's orderings, relabelled graphs, block
statistics and fingerprints against the JAX package's, and the port's
engine and API with ``reorder=`` against the reference's.

The orderings are numpy on both sides and must give the identical
permutation. An engine built with ``reorder=`` is a drop-in replacement:
callers pass colorings and read root tables in their own vertex ids, and
f32 totals and root tables agree with the reference's to ``rtol=1e-6``
(integer counts, exact in practice).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import build_engine  # noqa: E402
from repro.graph import Graph as RefGraph  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph import reorder as ref_reorder  # noqa: E402
from repro.graph.coloring import coloring_numpy  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.engines import CountingEngine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph import reorder  # noqa: E402
from repro_torch.graph.structure import Graph  # noqa: E402
from repro_torch.obs import metrics as _metrics  # noqa: E402

ORDER_NAMES = sorted(reorder.ORDERINGS)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _scrambled_grid(rows=40, cols=40, seed=3):
    """The reference suite's bandable graph with random labels, both
    packages' copies."""
    perm = np.random.default_rng(seed).permutation(rows * cols)
    return (reorder.apply_order(generators.grid_2d(rows, cols), perm),
            ref_reorder.apply_order(ref_gen.grid_2d(rows, cols), perm))


GRAPHS = {
    "scrambled_grid": _scrambled_grid,
    "er": lambda: (generators.erdos_renyi(300, 6.0, seed=1),
                   ref_gen.erdos_renyi(300, 6.0, seed=1)),
    "rmat": lambda: (generators.rmat(10), ref_gen.rmat(10)),
}


def _same_graph(g, g_ref):
    assert g.n == g_ref.n
    np.testing.assert_array_equal(g.indptr, g_ref.indptr)
    np.testing.assert_array_equal(g.indices, g_ref.indices)


@pytest.mark.parametrize("name", ORDER_NAMES)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_orderings_are_identical(gname, name):
    g, g_ref = GRAPHS[gname]()
    _same_graph(g, g_ref)
    got = reorder.ORDERINGS[name](g)
    want = ref_reorder.ORDERINGS[name](g_ref)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reorder.inverse_order(got),
                                  ref_reorder.inverse_order(want))
    _same_graph(reorder.apply_order(g, got),
                ref_reorder.apply_order(g_ref, want))


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_block_stats_and_fingerprint_are_identical(gname):
    g, g_ref = GRAPHS[gname]()
    for tile in (128, 16):
        assert g.bsr_block_stats(tile) == g_ref.bsr_block_stats(tile)
    assert g.fingerprint == g_ref.fingerprint
    order = reorder.rcm_order(g)
    gp = reorder.apply_order(g, order)
    gp_ref = ref_reorder.apply_order(g_ref, order)
    assert gp.bsr_block_stats() == gp_ref.bsr_block_stats()
    assert gp.fingerprint == gp_ref.fingerprint != g.fingerprint


def test_block_stats_of_an_empty_graph():
    edges = np.zeros((0, 2), np.int64)
    g, g_ref = Graph.from_edges(100, edges), RefGraph.from_edges(100, edges)
    assert g.bsr_block_stats() == g_ref.bsr_block_stats()
    assert g.bsr_block_stats()["occupied_blocks"] == 0
    assert g.fingerprint == g_ref.fingerprint


def test_rcm_cuts_the_occupied_blocks_of_a_scrambled_grid():
    g, _ = _scrambled_grid()
    before = g.bsr_block_stats(16)
    after = reorder.apply_order(g, reorder.rcm_order(g)).bsr_block_stats(16)
    assert after["occupied_blocks"] < before["occupied_blocks"]
    assert after["nnz_per_block"] > before["nnz_per_block"]


def test_apply_order_rejects_non_permutation():
    g = generators.erdos_renyi(20, 3.0, seed=0)
    with pytest.raises(ValueError):
        reorder.apply_order(g, np.zeros(g.n, np.int64))
    with pytest.raises(ValueError):
        reorder.apply_order(g, np.arange(g.n - 1))


def _colorings(n, k, b=3, seed=0):
    return np.stack([coloring_numpy(seed, i, n, k) for i in range(b)])


@pytest.mark.parametrize("method", ["bsr", "gather"])
@pytest.mark.parametrize("name", ORDER_NAMES)
def test_reordered_engine_matches_reference(name, method):
    # the reference's test_counts_invariant_single_and_batched, pgbsc
    g = generators.erdos_renyi(110, 6.0, seed=5)
    g_ref = ref_gen.erdos_renyi(110, 6.0, seed=5)
    eng = CountingEngine(g, "u5", reorder=name, spmm_method=method,
                         device="cpu")
    ref = build_engine(g_ref, "u5", engine="pgbsc", reorder=name)
    plain = CountingEngine(g, "u5", spmm_method=method, device="cpu")
    assert eng.reorder == name
    np.testing.assert_array_equal(eng._order, ref._order)
    cols = _colorings(g.n, eng.k)
    t, r = eng.count_colorful_batch(torch.as_tensor(cols))
    t_ref, r_ref = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-6)
    # root tables come back in the caller's vertex ids
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-6)
    t0, r0 = plain.count_colorful_batch(torch.as_tensor(cols))
    torch.testing.assert_close(t, t0, rtol=1e-6, atol=0)
    torch.testing.assert_close(r, r0, rtol=1e-6, atol=0)
    ts, rs = eng.count_colorful(torch.as_tensor(cols[0]))
    np.testing.assert_allclose(ts.item(), np.asarray(t_ref)[0], rtol=1e-6)
    np.testing.assert_allclose(rs.numpy(), np.asarray(r_ref)[0], rtol=1e-6)


@pytest.mark.parametrize("name", ORDER_NAMES)
def test_reordered_fused_bundle_matches_reference(name):
    # the reference's test_invariant_with_fusion_and_multi_template
    g = generators.erdos_renyi(100, 6.0, seed=6)
    g_ref = ref_gen.erdos_renyi(100, 6.0, seed=6)
    bundle = ("u5", "path5", "star5")
    eng = CountingEngine(g, bundle, plan="dedup", reorder=name, device="cpu")
    ref = build_engine(g_ref, bundle, engine="pgbsc", plan="dedup",
                       reorder=name, fuse_spmm_ema=True)
    assert eng.schedule.fused
    cols = _colorings(g.n, eng.k)
    t, roots = eng.count_colorful_batch(torch.as_tensor(cols))
    t_ref, roots_ref = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-6)
    assert len(roots) == len(roots_ref) == 3
    for r, r_ref in zip(roots, roots_ref):
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-6)
    ts, rs = eng.count_colorful(torch.as_tensor(cols[1]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(t_ref)[1], rtol=1e-6)
    for r, r_ref in zip(rs, roots_ref):
        np.testing.assert_allclose(r.numpy(), np.asarray(r_ref)[1],
                                   rtol=1e-6)


def test_reordered_chunked_engine_matches_reference():
    # reordering and colorset chunking together: u13 under 16 MiB
    g = generators.grid_2d(32, 32)
    g_ref = ref_gen.grid_2d(32, 32)
    eng = CountingEngine(g, "u13", plan="optimized", reorder="rcm",
                         memory_budget_bytes=16 << 20, device="cpu")
    ref = build_engine(g_ref, "u13", "pgbsc", plan="optimized",
                       reorder="rcm", memory_budget_bytes=16 << 20)
    assert eng.schedule.chunk_map
    got = eng.count_iterations_batch([0], seed=5)
    want = ref.count_iterations_batch([0], seed=5)
    assert got[0] == pytest.approx(want[0], rel=1e-6)


@pytest.mark.parametrize("name", ORDER_NAMES)
def test_api_count_with_reorder_equals_reference(name):
    g = generators.erdos_renyi(80, 5.0, seed=8)
    g_ref = ref_gen.erdos_renyi(80, 5.0, seed=8)
    got = api.count(g, "u5", max_iters=6, reorder=name, device="cpu")
    want = ref_api.count(g_ref, "u5", max_iters=6, reorder=name)
    plain = api.count(g, "u5", max_iters=6, device="cpu")
    assert got.estimate == pytest.approx(want.estimate, rel=1e-6)
    assert got.estimate == pytest.approx(plain.estimate, rel=1e-6)
    assert (got.iterations, got.target_met) == (want.iterations,
                                                want.target_met)


def test_query_carries_reorder_and_engine():
    g = generators.erdos_renyi(30, 3.0, seed=9)
    q = api.CountQuery(templates=("u3", "u5"), max_iters=2,
                       reorder="degree")
    assert q.engine == "pgbsc"
    cq = api.compile_query(g, q, device="cpu")
    assert all(e.reorder == "degree" for e in cq.engines)
    res = cq.run()
    want = ref_api.count_many(ref_gen.erdos_renyi(30, 3.0, seed=9),
                              ["u3", "u5"], max_iters=2, reorder="degree")
    for r, w in zip(res, want):
        assert r.estimate == pytest.approx(w.estimate, rel=1e-6)
    # the query's engine field reaches the engine: FASCIA on the
    # relabelled graph equals the reference's
    got = api.count(g, "u3", max_iters=2, engine="fascia", reorder="degree",
                    device="cpu")
    want = ref_api.count(ref_gen.erdos_renyi(30, 3.0, seed=9), "u3",
                         max_iters=2, engine="fascia", reorder="degree")
    assert got.estimate == pytest.approx(want.estimate, rel=1e-6)


def test_unknown_ordering_raises():
    g = generators.erdos_renyi(30, 3.0, seed=0)
    with pytest.raises(ValueError):
        CountingEngine(g, "u3", reorder="nope", device="cpu")
    with pytest.raises(ValueError):
        api.count(g, "u3", max_iters=1, reorder="nope", device="cpu")


def test_block_gauges_published():
    reg = _metrics.set_registry(_metrics.MetricsRegistry())
    try:
        g, _ = _scrambled_grid()
        CountingEngine(g, "u3", reorder="rcm", device="cpu")
        snap = reg.snapshot()["gauges"]
        b = snap['reorder_bsr_occupied_blocks{reorder="rcm",stage="before"}']
        a = snap['reorder_bsr_occupied_blocks{reorder="rcm",stage="after"}']
        assert a < b
        assert snap['reorder_bsr_block_density{reorder="rcm",'
                    'stage="after"}'] > 0
    finally:
        _metrics.set_registry(_metrics.MetricsRegistry())


def test_release_rebuilds_the_boundary_permutation():
    g, _ = _scrambled_grid(20, 20)
    eng = CountingEngine(g, "u5", reorder="rcm", device="cpu")
    cols = torch.as_tensor(_colorings(g.n, eng.k, b=2))
    before = eng.count_colorful_batch(cols)
    eng.release()
    after = eng.count_colorful_batch(cols)
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])
