"""Colorset chunking: the port's memory model, chunk packing, chunked eMA
and chunked engine against the JAX package's.

The memory model must choose what the reference chooses — batch, order,
chunk map, fused set, groups and modeled peak — for the same plan, k, n,
dtype, budget and fusion candidates (the port's own ``_fused_candidates``).
The chunked eMA's plain version (what the port runs on the CPU) and the
chunked engine must equal the reference's chunked walk to ``rtol=1e-6`` in
f32 (integer-valued tables, exact in practice).
"""

import importlib.util
from math import comb
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import build_engine  # noqa: E402
from repro.core import executor as ref_exec  # noqa: E402
from repro.core.templates import TreeTemplate as RefTree  # noqa: E402
from repro.core.templates import get_template as ref_template  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.coloring import coloring_numpy  # noqa: E402
from repro.kernels.ema import ops as ref_ema  # noqa: E402
from repro.kernels.spmm import ops as ref_spmm  # noqa: E402
from repro_torch.core import colorsets as cs  # noqa: E402
from repro_torch.core import executor as pexec  # noqa: E402
from repro_torch.core.engines import CountingEngine  # noqa: E402
from repro_torch.core.templates import TemplateSpec, TreeTemplate  # noqa: E402
from repro_torch.core.templates import get_template  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels.ema import ops as ema_ops  # noqa: E402
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the reference suite's k=12 binary tree (tests/test_executor.py, BINARY12)
B12_EDGES = [((i - 1) // 2, i) for i in range(1, 12)]
N_FULL = 1 << 20
BUDGETS_GIB = (0.25, 1, 2, 4, 8, 12, 16, 24, 32, 64)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _templates(name):
    if name == "b12":
        return TreeTemplate(B12_EDGES, name="b12"), RefTree(B12_EDGES,
                                                           name="b12")
    return get_template(name), ref_template(name)


def _choices(plan, ref_plan, k, n, budget, dtype, fused, groups):
    np_dt = np.dtype(f"f{dtype.itemsize}")
    kw = dict(memory_budget_bytes=budget, dtype=np_dt, fused=fused,
              fused_groups=groups)
    return (pexec.pick_execution(plan, k, n, **kw),
            ref_exec.pick_execution(ref_plan, k, n, **kw))


def _assert_same_choice(got, want):
    assert got.batch_size == want.batch_size
    assert got.fits == want.fits
    assert got.peak_bytes_per_coloring == want.peak_bytes_per_coloring
    s, r = got.schedule, want.schedule
    assert s.order == r.order
    assert s.free_tables == r.free_tables and s.free_y == r.free_y
    assert s.chunk_map == r.chunk_map
    assert s.fused == r.fused and s.fused_groups == r.fused_groups
    assert s.keep == r.keep


@pytest.mark.parametrize("gib", BUDGETS_GIB)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["u12", "u13", "u14", "b12"])
def test_pick_execution_equals_reference(name, dtype, gib):
    tpl, ref_tpl = _templates(name)
    # the fusion candidates do not depend on n: take them from a small
    # engine, then model the walk at n = 2^20
    small = CountingEngine(generators.grid_2d(4, 4), tpl, plan="optimized",
                           dtype=dtype, device="cpu")
    fused, groups = small._fused_candidates()
    got, want = _choices(tpl.plan_optimized, ref_tpl.plan_optimized,
                         tpl.k, N_FULL, int(gib * (1 << 30)), dtype, fused,
                         groups)
    _assert_same_choice(got, want)


def test_u13_at_16_gib_chunks_node_5_into_single_rows():
    tpl, ref_tpl = _templates("u13")
    small = CountingEngine(generators.grid_2d(4, 4), tpl, plan="optimized",
                           device="cpu")
    got, want = _choices(tpl.plan_optimized, ref_tpl.plan_optimized, 13,
                         N_FULL, 16 << 30, torch.float32,
                         *small._fused_candidates())
    _assert_same_choice(got, want)
    assert got.schedule.chunk_map == {5: 1716} and got.fits
    assert 7 in got.schedule.fused            # node 7 stays fused
    node = tpl.plan_optimized.nodes[5]
    assert (node.size, tpl.plan_optimized.nodes[node.passive].size) == (8, 7)


@pytest.mark.parametrize("k,t,t_a,q", [
    (13, 8, 1, 1716),       # u13 node 5: single-row chunks
    (12, 7, 3, 4),          # r > 1, several pairs per output row
    (12, 7, 3, 3),          # r = 12 of 35 rows: a short last chunk
    (10, 6, 2, 7),          # 210 rows in 7 chunks of 30
    (8, 5, 4, 1),           # one chunk holds everything
])
def test_pack_chunked_splits_identical(k, t, t_a, q):
    ia, ip = cs.split_tables(k, t, t_a)
    c_p = comb(k, t - t_a)
    got = ema_ops.pack_chunked_splits(ia, ip, c_p, q)
    want = ref_ema.pack_chunked_splits(ia, ip, c_p, q)
    for field in ("out_idx", "a_idx", "p_loc", "mask"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("n_chunks", "chunk_rows", "n_out_rows", "pair_block"):
        assert getattr(got, field) == getattr(want, field), field


def test_chunk_walk_keeps_every_real_pair_once():
    ia, ip = cs.split_tables(12, 7, 3)
    pack = ema_ops.pack_chunked_splits(ia, ip, comb(12, 4), 3)
    walk = ema_ops.chunk_walk(pack, "cpu")
    seen = []
    for q in range(pack.n_chunks):
        e0, e1 = walk.entry_ptr[q], walk.entry_ptr[q + 1]
        rows = walk.rows[e0:e1].tolist()
        assert rows == sorted(set(rows))               # one entry a row
        for e in range(e0, e1):
            for t in range(walk.pair_ptr[e], walk.pair_ptr[e + 1]):
                seen.append((q, rows[e - e0], int(walk.pair_a[t]),
                             int(walk.pair_p[t])))
    want = [(q, int(o), int(a), int(p))
            for q in range(pack.n_chunks)
            for o, a, p, m in zip(pack.out_idx[q], pack.a_idx[q],
                                  pack.p_loc[q], pack.mask[q]) if m]
    assert sorted(seen) == sorted(want) and len(seen) == ia.size


def _rand_tables(lead, c_a, c_p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, lead + (c_a, n)).astype(np.float32),
            rng.integers(0, 4, lead + (c_p, n)).astype(np.float32))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["unbatched", "b3"])
@pytest.mark.parametrize("k,t,t_a,q", [
    (10, 6, 1, 126),        # r = 2 (C(10, 5) = 252 rows)
    (10, 6, 1, 252),        # r = 1, single rows
    (9, 6, 2, 5),           # r = 26 of 126: short last chunk, many pairs
    (8, 5, 2, 3),           # r = 19 of 56: short last chunk
])
def test_ema_chunked_plain_equals_reference(lead, k, t, t_a, q):
    n = 300
    g = generators.erdos_renyi(n, 5.0, seed=2)
    g_ref = ref_gen.erdos_renyi(n, 5.0, seed=2)
    ia, ip = cs.split_tables(k, t, t_a)
    c_a, c_p = comb(k, t_a), comb(k, t - t_a)
    m_a, m_p = _rand_tables(lead, c_a, c_p, n, seed=k + q)
    pack = ema_ops.pack_chunked_splits(ia, ip, c_p, q)
    prep = spmm_ops.prepare(g, device="cpu")
    got = ema_ops.ema_chunked(
        torch.as_tensor(m_a), torch.as_tensor(m_p),
        ema_ops.chunk_walk(pack, "cpu"), lambda m: spmm_ops.spmm(m, prep))
    ref_prep = ref_spmm.prepare(g_ref, "segment")
    want = ref_ema.ema_chunked(
        jnp.asarray(m_a), jnp.asarray(m_p),
        ref_ema.pack_chunked_splits(ia, ip, c_p, q),
        lambda m: ref_spmm.spmm(m, ref_prep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # and the unchunked eMA of the whole SpMM
    whole = ema_ops.ema(torch.as_tensor(m_a),
                        spmm_ops.spmm(torch.as_tensor(m_p), prep),
                        torch.as_tensor(ia), torch.as_tensor(ip))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6)


def test_ema_chunked_bf16_within_tolerance():
    k, t, t_a, q = 9, 6, 2, 5
    n = 256
    ia, ip = cs.split_tables(k, t, t_a)
    c_a, c_p = comb(k, t_a), comb(k, t - t_a)
    m_a, m_p = _rand_tables((2,), c_a, c_p, n, seed=4)
    pack = ema_ops.pack_chunked_splits(ia, ip, c_p, q)
    got = ema_ops.ema_chunked(
        torch.as_tensor(m_a).bfloat16(), torch.as_tensor(m_p).bfloat16(),
        ema_ops.chunk_walk(pack, "cpu"), lambda m: m)
    assert got.dtype == torch.bfloat16
    want = ref_ema.ema_chunked(jnp.asarray(m_a), jnp.asarray(m_p),
                               ref_ema.pack_chunked_splits(ia, ip, c_p, q),
                               lambda m: m)
    want = np.asarray(want, np.float64)
    rel = np.abs(got.float().numpy() - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max() <= 1e-2


def _colorings(n, k, b, seed=0):
    return np.stack([coloring_numpy(seed, i, n, k) for i in range(b)])


@pytest.mark.parametrize("method", ["bsr", "gather"])
def test_binary12_chunked_engine_matches_reference(method):
    # the reference's TestColorsetChunking case, unfused as there (fused,
    # b12 fits this budget without chunking); each chunk's SpMM runs on
    # either operand
    g = generators.erdos_renyi(48, 3.0, seed=3)
    g_ref = ref_gen.erdos_renyi(48, 3.0, seed=3)
    budget = 2200 * g.n * 4
    tpl, ref_tpl = _templates("b12")
    eng = CountingEngine(g, tpl, plan="dedup", memory_budget_bytes=budget,
                         spmm_method=method, fuse_spmm_ema=False,
                         device="cpu")
    ref = build_engine(g_ref, ref_tpl, "pgbsc", plan="dedup",
                       memory_budget_bytes=budget)
    assert eng.schedule.chunk_map and eng.batch_size == 1
    assert eng.exec_choice.fits and eng.exec_choice.peak_bytes <= budget
    assert eng.schedule.chunk_map == ref.schedule.chunk_map
    assert eng.schedule.order == ref.schedule.order
    cols = _colorings(g.n, 12, b=3)
    got, root = eng.count_colorful(torch.as_tensor(cols[0]))
    want, want_root = ref.count_colorful(jnp.asarray(cols[0]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(root.numpy(), np.asarray(want_root),
                               rtol=1e-6)
    got_b, _ = eng.count_colorful_batch(torch.as_tensor(cols))
    want_b, _ = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6)
    per = eng.count_iterations_batch([0, 1, 2], seed=7)
    ref_per = ref.count_iterations_batch([0, 1, 2], seed=7)
    for it in ref_per:
        assert per[it] == pytest.approx(ref_per[it], rel=1e-6)


def test_chunked_batch_override_matches_unchunked():
    # batch_size > 1 on a chunked schedule: strided chunks are copied
    g = generators.erdos_renyi(40, 3.0, seed=5)
    tpl, _ = _templates("b12")
    eng = CountingEngine(g, tpl, plan="dedup", fuse_spmm_ema=False,
                         memory_budget_bytes=2200 * g.n * 4, batch_size=3,
                         device="cpu")
    ref = CountingEngine(g, tpl, plan="dedup", device="cpu")
    assert eng.schedule.chunk_map and not ref.schedule.chunk_map
    cols = torch.as_tensor(_colorings(g.n, 12, b=3, seed=2))
    got, root = eng.count_colorful_batch(cols)
    want, want_root = ref.count_colorful_batch(cols)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(root, want_root, rtol=1e-6, atol=0)


def test_u13_under_16_mib_runs_chunked_as_the_reference():
    g = generators.grid_2d(32, 32)
    g_ref = ref_gen.grid_2d(32, 32)
    budget = 16 << 20
    eng = CountingEngine(g, "u13", plan="optimized",
                         memory_budget_bytes=budget, device="cpu")
    assert eng.schedule.chunk_map == {5: 1716} and eng.exec_choice.fits
    assert eng.schedule.fused == (7,)
    ref = build_engine(g_ref, "u13", "pgbsc", plan="optimized",
                       memory_budget_bytes=budget)
    assert ref.schedule.chunk_map
    got = eng.count_iterations_batch([0, 1], seed=3)
    want = ref.count_iterations_batch([0, 1], seed=3)
    for it in want:
        assert got[it] == pytest.approx(want[it], rel=1e-6)
    assert eng.measured_peak_bytes <= eng.peak_table_bytes


def _census(k):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(e, r) for e, r in mod.census_trees(k)]


def test_bundle_groups_are_dropped_on_the_chunked_path():
    g = generators.grid_2d(8, 8)
    g_ref = ref_gen.grid_2d(8, 8)
    trees = [TemplateSpec(edges=e, root=r).tree for e, r in _census(8)]
    whole = CountingEngine(g, trees, plan="dedup", device="cpu")
    assert whole.schedule.fused_groups            # groups when it fits
    budget = int(0.9 * whole.exec_choice.peak_bytes_per_coloring)
    eng = CountingEngine(g, trees, plan="dedup", memory_budget_bytes=budget,
                         device="cpu")
    assert eng.schedule.chunk_map and not eng.schedule.fused_groups
    members = {m for grp in whole.schedule.fused_groups for m in grp}
    assert not members & set(eng.schedule.fused)
    # the reference's model drops them the same way
    from repro.core.templates import TemplateSpec as RefSpec
    from repro.core.templates import compile_fused_plan as ref_compile
    ref_plan = ref_compile([RefSpec(edges=e, root=r).tree
                            for e, r in _census(8)], optimize=False)
    keep = tuple(i for i in eng.roots if i != eng.plan.n_nodes - 1)
    want = ref_exec.pick_execution(
        ref_plan.plan, 8, g.n, memory_budget_bytes=budget, keep=keep,
        fused=whole._fused_candidates()[0],
        fused_groups=whole.schedule.fused_groups)
    _assert_same_choice(eng.exec_choice, want)
    # and the chunked bundle counts what the reference counts
    ref = build_engine(g_ref, [RefSpec(edges=e, root=r).tree
                               for e, r in _census(8)], "pgbsc",
                       plan="dedup", memory_budget_bytes=budget)
    per = eng.count_iterations_batch([0, 1], seed=1)
    ref_per = ref.count_iterations_batch([0, 1], seed=1)
    for it in ref_per:
        np.testing.assert_allclose(per[it], ref_per[it], rtol=1e-6)


def test_best_effort_when_even_single_rows_do_not_fit():
    g = generators.grid_2d(16, 16)
    g_ref = ref_gen.grid_2d(16, 16)
    budget = 64 * g.n * 4                    # far below any u13 floor
    eng = CountingEngine(g, "u13", plan="optimized",
                         memory_budget_bytes=budget, device="cpu")
    ref = build_engine(g_ref, "u13", "pgbsc", plan="optimized",
                       memory_budget_bytes=budget)
    assert not eng.exec_choice.fits and eng.batch_size == 1
    assert eng.schedule.chunk_map
    got = eng.count_iterations_batch([0], seed=0)
    want = ref.count_iterations_batch([0], seed=0)
    assert got[0] == pytest.approx(want[0], rel=1e-6)
