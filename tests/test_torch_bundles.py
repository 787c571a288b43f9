"""Multi-template bundles: the port's fused plans, shared-passive groups,
``count_many``, ``estimate_many`` and ``motif_features`` against the JAX
package's, and the gather engine against its ``pallas_gather`` engine.

The census is every free tree on k vertices, rooted at a center, from the
enumerator in ``chip_smoke.py`` (loaded by path). The reference engines run
their Pallas kernels in interpret mode where the path reaches them; the
port runs on the CPU (the kernels' plain versions). f32 results agree to
``rtol=1e-6`` (integer counts, exact in practice).
"""

import importlib.util
from math import comb
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core import executor as ref_exec  # noqa: E402
from repro.core.engines import CountingEngine as RefEngine  # noqa: E402
from repro.core.motif_features import \
    motif_features as ref_motif_features  # noqa: E402
from repro.core.templates import TemplateSpec as RefSpec  # noqa: E402
from repro.core.templates import \
    compile_fused_plan as ref_compile  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.coloring import coloring_numpy  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import executor as pexec  # noqa: E402
from repro_torch.core.engines import CountingEngine  # noqa: E402
from repro_torch.core.templates import TemplateSpec, TreeTemplate  # noqa: E402
from repro_torch.core.templates import compile_fused_plan  # noqa: E402
from repro_torch.graph import generators  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _census_trees(k):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.census_trees(k)


CENSUS8 = _census_trees(8)


def census(k=8, ref=False):
    cls = RefSpec if ref else TemplateSpec
    trees = CENSUS8 if k == 8 else _census_trees(k)
    return [cls(edges=e, root=r, name=f"tree{k}_{i}")
            for i, (e, r) in enumerate(trees)]


def shared_bundle(ref=False):
    """The reference suite's groupable pair (``_shared_passive_bundle`` in
    tests/test_kernels_fused.py): one unrooted fork rooted two ways, whose
    dedup plan shares a path2 passive between T1's root and T2's interior
    node."""
    cls = RefSpec if ref else TemplateSpec
    return [cls(edges=((0, 1), (1, 2), (0, 3), (0, 4)), name="sharedp_a"),
            cls(edges=((0, 1), (1, 2), (2, 3), (1, 4)), name="sharedp_b")]


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("k,count", [(5, 3), (6, 6), (7, 11), (8, 23),
                                     (9, 47), (10, 106)])
def test_census_enumerator_counts_free_trees(k, count):
    """OEIS A000055, and one tree per isomorphism class."""
    trees = _census_trees(k)
    assert len(trees) == count
    hashes = set()
    for edges, root in trees:
        t = TreeTemplate(edges, root=root)
        assert t.k == k
        # free-tree identity: the least rooted form over all roots
        hashes.add(min(TreeTemplate(edges, root=r).canonical_hash
                       for r in range(k)))
    assert len(hashes) == count


BUNDLES = {
    "census8": lambda ref: census(8, ref),
    "shared": shared_bundle,
    "u5_path5_star5": lambda ref: ["u5", "path5", "star5"],
}


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("bname", sorted(BUNDLES))
def test_compile_fused_plan_matches_reference(bname, optimize):
    got = compile_fused_plan(BUNDLES[bname](False), optimize=optimize)
    want = ref_compile(BUNDLES[bname](True), optimize=optimize)
    assert got.roots == want.roots and got.k == want.k
    assert len(got.plan.nodes) == len(want.plan.nodes)
    for a, b in zip(got.plan.nodes, want.plan.nodes):
        assert (a.vertices, a.root, a.active, a.passive) \
            == (b.vertices, b.root, b.active, b.passive)


def test_canonical_hash_matches_reference():
    for a, b in zip(census(8), census(8, ref=True)):
        assert a.canonical_hash == b.canonical_hash
        assert a.tree.rooted_canonical == b.tree.rooted_canonical


@pytest.mark.parametrize("bname", ["census8", "shared"])
def test_group_schedule_matches_reference(bname):
    """The same plan, fused nodes, groups and kept roots give the same
    regrouped order, frees and modeled peak in both executors."""
    eng = CountingEngine(generators.grid_2d(8, 8), BUNDLES[bname](False),
                         plan="dedup", device="cpu")
    keep = tuple(i for i in eng.roots if i != eng.plan.n_nodes - 1)
    kw = dict(keep=keep, fused=eng.schedule.fused,
              fused_groups=eng.schedule.fused_groups)
    got = pexec.compute_schedule(eng.plan, eng.k, **kw)
    ref_plan = ref_compile(BUNDLES[bname](True), optimize=False).plan
    want = ref_exec.compute_schedule(ref_plan, eng.k, **kw)
    assert got.fused_groups and got.fused_groups == want.fused_groups
    assert (got.order, got.free_tables, got.free_y, got.keep, got.fused) \
        == (want.order, want.free_tables, want.free_y, want.keep,
            want.fused)
    assert pexec.simulate_peak_rows(eng.plan, eng.k, got) \
        == ref_exec.simulate_peak_rows(ref_plan, eng.k, want)


def test_census_groups_form_on_root_pairs():
    """Every admitted group is made of template roots that share one
    passive child and fit the card's group model; the rest of the
    shared-passive consumers stay on the y-cache."""
    eng = CountingEngine(generators.grid_2d(8, 8), census(8), plan="dedup",
                         device="cpu")
    groups = eng.schedule.fused_groups
    assert len(groups) == 2
    for grp in groups:
        assert set(grp) <= set(eng.roots)
        assert len({eng.plan.nodes[m].passive for m in grp}) == 1
        assert all(eng.fusion_report[m] == "admitted_shared" for m in grp)


def test_census10_admits_at_least_three_groups():
    eng = CountingEngine(generators.grid_2d(8, 8), census(10), plan="dedup",
                         device="cpu", memory_budget_bytes=1 << 34)
    assert len(eng.roots) == 106
    assert len(eng.schedule.fused_groups) >= 3
    assert max(len(g) for g in eng.schedule.fused_groups) <= 16


def _ref_engine(g_ref, bundle, **kw):
    return RefEngine(g_ref, bundle, plan="dedup", spmm_method="pallas_bsr",
                     use_pallas_ema=True, fuse_spmm_ema=True, **kw)


def test_shared_bundle_group_and_column_drop_match_reference():
    """The group forms in both packages, pays the shared passive's SpMM
    once (20 column-ops against 30 with per-consumer fusion) and counts
    the same."""
    g = generators.erdos_renyi(80, 6.0, seed=9)
    g_ref = ref_gen.erdos_renyi(80, 6.0, seed=9)
    eng = CountingEngine(g, shared_bundle(), plan="dedup", device="cpu")
    ref = _ref_engine(g_ref, [s.tree for s in shared_bundle(ref=True)])
    assert eng.schedule.fused_groups == ref.schedule.fused_groups
    assert len(eng.schedule.fused_groups) == 1
    assert eng.fusion_report == ref.fusion_report
    cols = eng.spmm_cols_per_coloring
    grp = eng.schedule.fused_groups[0]
    c_p = comb(5, eng.plan.nodes[eng.plan.nodes[grp[0]].passive].size)
    assert (cols, cols + (len(grp) - 1) * c_p) == (20, 30)
    assert cols == ref.spmm_cols_per_coloring
    cols_np = np.stack([coloring_numpy(0, i, g.n, 5) for i in range(2)])
    got, roots = eng.count_colorful_batch(torch.as_tensor(cols_np))
    want, want_roots = ref.count_colorful_batch(jnp.asarray(cols_np))
    assert eng.n_spmm_cols_dispatched == 2 * cols
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for a, b in zip(roots, want_roots):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_chain_consumers_stay_on_ycache():
    eng = CountingEngine(generators.erdos_renyi(60, 5.0, seed=10),
                         ["u5", "path5", "star5"], plan="dedup",
                         device="cpu")
    assert not eng.schedule.fused_groups
    assert "admitted_shared" not in eng.fusion_report.values()


def test_grouped_and_unfused_walks_agree():
    g = generators.erdos_renyi(120, 5.0, seed=2)
    cols = torch.as_tensor(np.stack([coloring_numpy(1, i, g.n, 8)
                                     for i in range(3)]))
    grouped = CountingEngine(g, census(8), plan="dedup", device="cpu",
                             batch_size=2)
    plain = CountingEngine(g, census(8), plan="dedup", device="cpu",
                           fuse_spmm_ema=False)
    assert grouped.schedule.fused_groups and not plain.schedule.fused
    got, got_roots = grouped.count_colorful_batch(cols)
    want, want_roots = plain.count_colorful_batch(cols)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert got.shape == (3, 23) and len(got_roots) == 23
    for a, b in zip(got_roots, want_roots):
        assert torch.equal(a, b)
    one, one_roots = grouped.count_colorful(cols[1])
    assert torch.equal(one, got[1]) and one_roots[0].shape == (1, g.n)


def test_measured_peak_within_model_with_groups():
    g = generators.erdos_renyi(150, 5.0, seed=4)
    eng = CountingEngine(g, census(8), plan="dedup", device="cpu",
                         batch_size=3)
    assert eng.schedule.fused_groups
    cols = np.stack([coloring_numpy(0, i, g.n, 8) for i in range(3)])
    eng.count_colorful_batch(torch.as_tensor(cols))
    model = pexec.peak_table_bytes(eng.plan, eng.k, g.n, batch=3,
                                   schedule=eng.schedule)
    assert 0 < eng.measured_peak_bytes <= model


def test_count_many_census_matches_reference():
    g = generators.grid_2d(12, 12)
    g_ref = ref_gen.grid_2d(12, 12)
    got = api.count_many(g, census(8), plan="dedup", max_iters=6,
                         round_size=4, seed=3, device="cpu")
    want = ref_api.count_many(g_ref, census(8, ref=True), plan="dedup",
                              max_iters=6, round_size=4, seed=3)
    assert len(got) == len(want) == 23
    for a, b in zip(got, want):
        assert (a.iterations, a.target_met, a.shared_group) \
            == (b.iterations, b.target_met, b.shared_group)
        np.testing.assert_allclose([a.estimate, a.stderr],
                                   [b.estimate, b.stderr], rtol=1e-6)


def test_count_many_groups_by_k_and_keeps_input_order():
    g = generators.grid_2d(12, 12)
    g_ref = ref_gen.grid_2d(12, 12)
    names = ["u7", "u5", "path5", "u3", "star5"]
    q = api.compile_query(g, api.CountQuery(templates=tuple(names),
                                            max_iters=4), device="cpu")
    assert [sorted(idxs) for idxs, _ in q.groups] == [[3], [1, 2, 4], [0]]
    got = q.run()
    want = ref_api.count_many(g_ref, names, max_iters=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.estimate, b.estimate, rtol=1e-6)
        assert a.shared_group == b.shared_group
    solo = api.count(g, "path5", max_iters=4, device="cpu")
    assert solo.estimate == got[2].estimate


def test_estimate_many_census_matches_reference():
    g = generators.erdos_renyi(90, 5.0, seed=6)
    g_ref = ref_gen.erdos_renyi(90, 5.0, seed=6)
    eng = CountingEngine(g, census(8), plan="dedup", device="cpu")
    ref = _ref_engine(g_ref, [s.tree for s in census(8, ref=True)])
    assert eng.roots == ref.roots
    got = eng.estimate_many(3, seed=5)
    want = ref.estimate_many(3, seed=5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["samples"], b["samples"], rtol=1e-6)
        assert a["alpha"] == b["alpha"]
    with pytest.raises(ValueError, match="estimate_many"):
        eng.estimate(2)


def test_motif_features_match_reference():
    g = generators.erdos_renyi(80, 6.0, seed=0)
    g_ref = ref_gen.erdos_renyi(80, 6.0, seed=0)
    names = ["u5", "path5", "star5", "u3", "path4", "star4"]
    got = api.motif_features(g, names, n_iters=4, device="cpu")
    want = ref_motif_features(g_ref, names, n_iters=4)
    assert got.shape == (80, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("tname", ["u5", "u7"])
def test_gather_engine_matches_reference_gather_engine(tname):
    g = generators.rmat(8, 8, seed=1)
    g_ref = ref_gen.rmat(8, 8, seed=1)
    eng = CountingEngine(g, tname, plan="optimized", spmm_method="gather",
                         fuse_spmm_ema=False, device="cpu")
    ref = RefEngine(g_ref, tname, plan="optimized",
                    spmm_method="pallas_gather")
    assert eng._fused_prep is None
    cols = np.stack([coloring_numpy(7, i, g.n, eng.k) for i in range(3)])
    got, root = eng.count_colorful_batch(torch.as_tensor(cols))
    want, want_root = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(root.numpy(), np.asarray(want_root),
                               rtol=1e-6)


def test_gather_engine_with_fusion_walks_bsr_for_fused_nodes():
    g = generators.rmat(8, 8, seed=1)
    eng = CountingEngine(g, "u12", plan="optimized", spmm_method="gather",
                         device="cpu")
    plain = CountingEngine(g, "u12", plan="optimized", device="cpu")
    assert eng.schedule.fused and eng._fused_prep is not None
    assert eng.estimate(3)["samples"] == plain.estimate(3)["samples"]
