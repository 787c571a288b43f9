"""The paper's baselines on the port: FASCIA and PFASCIA (row-major tables,
the ELL sweep), the ``segment``/``ell``/``dense`` SpMM backends and the
executor's cache-less walk, against the JAX package and the brute-force
oracle on the same numpy inputs.

Row-major engines agree with the reference's to ``rtol=1e-6`` in f32
(integer counts below 2^24: exact in practice) and ``1e-2`` with bf16
storage; against the oracle the colorful counts are exact. The memory
model's choices for ``passive_cache=False`` (FASCIA) and
``allow_chunking=False`` (both baselines) equal the reference's field for
field, and the static work counts are the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import executor as ref_exec  # noqa: E402
from repro.core.engines import CountingEngine as RefEngine  # noqa: E402
from repro.core.templates import TreeTemplate as RefTree  # noqa: E402
from repro.core.templates import get_template as ref_template  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.coloring import coloring_numpy  # noqa: E402
from repro.kernels.spmm import ops as ref_spmm  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import ENGINES, build_engine  # noqa: E402
from repro_torch.core import executor as pexec  # noqa: E402
from repro_torch.core.engines import CountingEngine  # noqa: E402
from repro_torch.core.oracle import count_colorful_embeddings  # noqa: E402
from repro_torch.core.templates import TreeTemplate, get_template  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.structure import Graph  # noqa: E402
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402

ROWMAJOR = ("fascia", "pfascia")
# graph name -> (port graph, reference graph); small enough for u10
GRAPHS = {
    "er": lambda m: m.erdos_renyi(40, 3.5, seed=10),
    "grid": lambda m: m.grid_2d(6, 6),
    "star": lambda m: m.star(12),
    "path": lambda m: m.path_graph(14),
}
B12_EDGES = [((i - 1) // 2, i) for i in range(1, 12)]
N_FULL = 1 << 20
BUDGETS_GIB = (0.25, 2, 8, 32)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _graphs(name):
    return GRAPHS[name](generators), GRAPHS[name](ref_gen)


def _colorings(n, k, b=2, seed=5):
    return np.stack([coloring_numpy(seed, i, n, k) for i in range(b)])


# ------------------------------------------------------------- the engines
@pytest.mark.parametrize("plan", ["plain", "dedup"])
@pytest.mark.parametrize("tname", ["u3", "u5", "u7", "u10"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("engine", ROWMAJOR)
def test_rowmajor_matches_reference(engine, gname, tname, plan):
    g, g_ref = _graphs(gname)
    eng = CountingEngine(g, tname, engine=engine, plan=plan, device="cpu")
    ref = RefEngine(g_ref, tname, engine=engine, plan=plan)
    cols = _colorings(g.n, eng.k)
    got, root = eng.count_colorful_batch(torch.as_tensor(cols))
    want, want_root = ref.count_colorful_batch(jnp.asarray(cols))
    assert root.shape == (len(cols), g.n, 1) == np.shape(want_root)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(root.numpy(), np.asarray(want_root),
                               rtol=1e-6)
    assert eng.batch_size == ref.batch_size


# the reference suite's exactness cases (tests/test_engines.py)
ORACLE_CASES = [
    ("er18", "u3"), ("er18", "path4"), ("er18", "star4"), ("er18", "u5"),
    ("er18", "path5"), ("grid4", "u3"), ("grid4", "u5"), ("star10", "star4"),
    ("path12", "path5"), ("disconnected", "u3"),
]
ORACLE_GRAPHS = {
    "er18": lambda: generators.erdos_renyi(18, 3.5, seed=10),
    "grid4": lambda: generators.grid_2d(4, 4),
    "star10": lambda: generators.star(10),
    "path12": lambda: generators.path_graph(12),
    "disconnected": lambda: Graph.from_edges(
        8, np.array([[0, 1], [1, 2], [4, 5], [5, 6], [6, 7]])),
}


@pytest.mark.parametrize("gname,tname", ORACLE_CASES,
                         ids=[f"{g}-{t}" for g, t in ORACLE_CASES])
@pytest.mark.parametrize("engine", ENGINES)
def test_every_engine_equals_the_oracle(engine, gname, tname):
    g = ORACLE_GRAPHS[gname]()
    t = get_template(tname)
    for it in range(2):
        colors = coloring_numpy(0, it, g.n, t.k)
        want = count_colorful_embeddings(g, t, colors)
        total, root = build_engine(g, t, engine, device="cpu"
                                   ).count_colorful(torch.tensor(colors))
        assert float(total) == want, (engine, gname, tname, it)
        assert not torch.isnan(root).any()


@pytest.mark.parametrize("tname", ["u5", "u7"])
@pytest.mark.parametrize("engine", ROWMAJOR)
def test_rowmajor_bf16_within_tolerance(engine, tname):
    g, g_ref = _graphs("er")
    eng = CountingEngine(g, tname, engine=engine, dtype=torch.bfloat16,
                         device="cpu")
    ref = RefEngine(g_ref, tname, engine=engine, dtype=jnp.bfloat16)
    cols = _colorings(g.n, eng.k)
    got, root = eng.count_colorful_batch(torch.as_tensor(cols))
    want, _ = ref.count_colorful_batch(jnp.asarray(cols))
    assert root.dtype == torch.bfloat16 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-2)


@pytest.mark.parametrize("reorder", ["rcm", "degree"])
@pytest.mark.parametrize("engine", ROWMAJOR)
def test_rowmajor_reorder_matches_reference(engine, reorder):
    """The boundary permutation moves row-major roots along axis -2."""
    g, g_ref = _graphs("er")
    eng = CountingEngine(g, "u7", engine=engine, reorder=reorder,
                         device="cpu")
    ref = RefEngine(g_ref, "u7", engine=engine, reorder=reorder)
    plain = CountingEngine(g, "u7", engine=engine, device="cpu")
    cols = _colorings(g.n, 7)
    got, root = eng.count_colorful_batch(torch.as_tensor(cols))
    want, want_root = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(root.numpy(), np.asarray(want_root),
                               rtol=1e-6)
    _, plain_root = plain.count_colorful_batch(torch.as_tensor(cols))
    torch.testing.assert_close(root, plain_root, rtol=1e-6, atol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_iteration_sums_do_not_depend_on_the_batch(engine):
    g, _ = _graphs("er")
    eng = CountingEngine(g, "u7", engine=engine, device="cpu")
    ids = list(range(7))
    runs = [eng.count_iterations_batch(ids, seed=3, batch_size=b)
            for b in (1, 3, 4, 7)]
    assert all(r == runs[0] for r in runs[1:])


@pytest.mark.parametrize("engine", ROWMAJOR)
def test_rowmajor_bundle_matches_reference(engine):
    g, g_ref = _graphs("er")
    names = ["u5", "path5", "star5"]
    eng = CountingEngine(g, names, engine=engine, plan="dedup", device="cpu")
    ref = RefEngine(g_ref, names, engine=engine, plan="dedup")
    cols = _colorings(g.n, 5, b=3)
    got, roots = eng.count_colorful_batch(torch.as_tensor(cols))
    want, want_roots = ref.count_colorful_batch(jnp.asarray(cols))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for r, w in zip(roots, want_roots):
        np.testing.assert_allclose(r.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("engine", ROWMAJOR)
def test_api_count_runs_the_baselines(engine):
    g, g_ref = _graphs("er")
    got = api.count(g, "u5", max_iters=4, engine=engine, device="cpu")
    want = ref_api.count(g_ref, "u5", max_iters=4, engine=engine)
    assert got.estimate == pytest.approx(want.estimate, rel=1e-6)
    q = api.compile_query(g, api.CountQuery(templates=("u5", "star5"),
                                            max_iters=2, engine=engine),
                          device="cpu")
    assert all(e.engine == engine for e in q.engines)
    res = q.run()
    ref = ref_api.count_many(g_ref, ["u5", "star5"], max_iters=2,
                             engine=engine)
    for r, w in zip(res, ref):
        assert r.estimate == pytest.approx(w.estimate, rel=1e-6)


def test_release_rebuilds_rowmajor_operands():
    g, _ = _graphs("grid")
    eng = CountingEngine(g, "u5", engine="pfascia", device="cpu")
    cols = torch.as_tensor(_colorings(g.n, 5))
    before, _ = eng.count_colorful_batch(cols)
    eng.release()
    assert eng._nbr is None
    after, _ = eng.count_colorful_batch(cols)
    assert torch.equal(before, after)
    empty, root = eng.count_colorful_batch(cols[:0])
    assert empty.shape == (0,) and root.shape == (0, g.n, 1)


# ------------------------------------------------------------- accounting
@pytest.mark.parametrize("plan", ["plain", "dedup", "optimized"])
@pytest.mark.parametrize("tname", ["u5", "u10", "u12"])
@pytest.mark.parametrize("engine", ENGINES)
def test_work_and_spmm_cols_equal_reference(engine, tname, plan):
    g, g_ref = _graphs("grid")
    eng = CountingEngine(g, tname, engine=engine, plan=plan,
                         fuse_spmm_ema=False, device="cpu")
    ref = RefEngine(g_ref, tname, engine=engine, plan=plan)
    assert dataclasses.asdict(eng.work) == dataclasses.asdict(ref.work)
    assert eng.flops_per_iteration == ref.flops_per_iteration
    assert eng.spmm_cols_per_coloring == ref.spmm_cols_per_coloring
    assert eng.peak_table_bytes == ref.peak_table_bytes


@pytest.mark.parametrize("engine", ENGINES)
def test_u12_plain_work_at_mesh_scale(engine):
    """The static counts the card's regimes are read against: one
    coloring of the plain u12 plan on grid_2d(1024, 1024)."""
    g = generators.grid_2d(1024, 1024)
    assert (g.n, g.m) == (N_FULL, 4_190_208)
    # the edge-stream operand: no dense blocks on the host
    eng = CountingEngine(g, "u12", engine=engine, plan="plain",
                         spmm_method="segment", fuse_spmm_ema=False,
                         device="cpu")
    sweep = {"fascia": 144.4, "pfascia": 8.8, "pgbsc": 8.8}[engine]
    assert round(eng.work.spmm_flops / 1e9, 1) == sweep
    assert round(eng.work.ema_flops / 1e9, 1) == 72.3


# ------------------------------------------------------- the memory model
def _templates(name):
    if name == "b12":
        return TreeTemplate(B12_EDGES, name="b12"), RefTree(B12_EDGES,
                                                           name="b12")
    return get_template(name), ref_template(name)


@pytest.mark.parametrize("plan", ["plain", "optimized"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["u3", "u5", "u7", "u10", "u12", "u13",
                                  "u14", "b12"])
@pytest.mark.parametrize("engine", ENGINES)
def test_pick_execution_equals_reference(engine, name, dtype, plan):
    """passive_cache=(engine != "fascia"), allow_chunking=(engine ==
    "pgbsc"), as the engines call it (no fusion candidates)."""
    tpl, ref_tpl = _templates(name)
    p = tpl.plan if plan == "plain" else tpl.plan_optimized
    rp = ref_tpl.plan if plan == "plain" else ref_tpl.plan_optimized
    kw = dict(dtype=np.dtype(dtype), passive_cache=(engine != "fascia"),
              allow_chunking=(engine == "pgbsc"))
    for gib in BUDGETS_GIB:
        budget = int(gib * (1 << 30))
        got = pexec.pick_execution(p, tpl.k, N_FULL,
                                   memory_budget_bytes=budget, **kw)
        want = ref_exec.pick_execution(rp, tpl.k, N_FULL,
                                       memory_budget_bytes=budget, **kw)
        assert (got.batch_size, got.fits, got.peak_bytes_per_coloring,
                got.budget_bytes) == (want.batch_size, want.fits,
                                      want.peak_bytes_per_coloring,
                                      want.budget_bytes), gib
        assert dataclasses.asdict(got.schedule) == \
            dataclasses.asdict(want.schedule), gib


@pytest.mark.parametrize("name", ["u7", "u12", "b12"])
def test_cacheless_schedule_and_peaks_equal_reference(name):
    tpl, ref_tpl = _templates(name)
    for passive_cache in (True, False):
        got = pexec.compute_schedule(tpl.plan, tpl.k,
                                     passive_cache=passive_cache)
        want = ref_exec.compute_schedule(ref_tpl.plan, tpl.k,
                                         passive_cache=passive_cache)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert pexec.simulate_peak_rows(tpl.plan, tpl.k, got) == \
            ref_exec.simulate_peak_rows(ref_tpl.plan, tpl.k, want)
        for batch in (1, 3):
            assert pexec.keep_everything_bytes(
                tpl.plan, tpl.k, 1000, batch,
                passive_cache=passive_cache) == ref_exec.keep_everything_bytes(
                ref_tpl.plan, tpl.k, 1000, batch, passive_cache=passive_cache)
    # a cache-less walk frees no y entries and needs combine_direct
    assert not any(got.free_y)
    with pytest.raises(ValueError, match="combine_direct"):
        pexec.PlanExecutor(tpl.plan, got).run(torch.zeros(tpl.k, 4))


def test_no_chunking_returns_best_effort_batch_one():
    tpl, ref_tpl = _templates("u13")
    kw = dict(memory_budget_bytes=1 << 30, allow_chunking=False)
    got = pexec.pick_execution(tpl.plan_optimized, 13, N_FULL, **kw)
    want = ref_exec.pick_execution(ref_tpl.plan_optimized, 13, N_FULL, **kw)
    assert (got.batch_size, got.fits) == (1, False) == (want.batch_size,
                                                        want.fits)
    assert not got.schedule.chunk_map
    assert got.peak_bytes_per_coloring == want.peak_bytes_per_coloring


@pytest.mark.parametrize("engine", ROWMAJOR)
def test_rowmajor_measured_peak_within_model(engine):
    g, _ = _graphs("grid")
    eng = CountingEngine(g, "u7", engine=engine, device="cpu")
    assert eng.schedule.passive_cache == (engine == "pfascia")
    assert not eng.schedule.chunk_map and not eng.schedule.fused
    eng.count_colorful_batch(torch.as_tensor(_colorings(g.n, 7)))
    model = eng.exec_choice.peak_bytes_per_coloring * 2
    assert 0 < eng.measured_peak_bytes <= model


# ------------------------------------------------------- the SpMM backends
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("gname", ["er", "grid", "star"])
@pytest.mark.parametrize("method", ["segment", "ell", "dense"])
def test_spmm_backend_matches_reference(method, gname, dtype, rtol):
    g, g_ref = _graphs(gname)
    m = np.random.default_rng(1).integers(0, 5, (2, 7, g.n)).astype(
        np.float32)
    want = np.asarray(ref_spmm.spmm(jnp.asarray(m),
                                    ref_spmm.prepare(g_ref, method)))
    prep = spmm_ops.prepare(g, method, dtype=dtype, device="cpu")
    got = spmm_ops.spmm(torch.as_tensor(m).to(dtype), prep)
    assert got.dtype == dtype and got.shape == m.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol)
    again = spmm_ops.spmm(torch.as_tensor(m).to(dtype), prep)
    assert torch.equal(got, again)


@pytest.mark.parametrize("method", ["segment", "ell", "dense"])
def test_spmm_backend_equals_bsr(method):
    g, _ = _graphs("er")
    m = torch.as_tensor(np.random.default_rng(2).integers(
        0, 9, (3, 5, g.n)).astype(np.float32))
    want = spmm_ops.spmm(m, spmm_ops.prepare(g, "bsr", device="cpu"))
    got = spmm_ops.spmm(m, spmm_ops.prepare(g, method, device="cpu"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["segment", "ell", "dense"])
def test_pgbsc_engine_on_each_backend(method):
    g, g_ref = _graphs("grid")
    eng = CountingEngine(g, "u7", spmm_method=method, fuse_spmm_ema=False,
                         device="cpu")
    ref = RefEngine(g_ref, "u7", spmm_method=method)
    assert isinstance(eng._spmm_prep, spmm_ops.OpsPrep)
    cols = _colorings(g.n, 7)
    got, _ = eng.count_colorful_batch(torch.as_tensor(cols))
    want, _ = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_ell_and_dense_equal_reference_arrays(gname):
    g, g_ref = _graphs(gname)
    assert g.max_degree == g_ref.max_degree
    for got, want in zip(g.ell(), g_ref.ell()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g.to_dense(), g_ref.to_dense())
