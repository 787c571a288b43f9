"""The port's block autotuner and kernel roofline against the JAX package.

The sweep machinery runs here on stand-in callables (timed by
``perf_counter`` off the card); the CUDA launch shapes themselves are held
against their plain versions on the card (``tests/test_torch_cuda.py``).
With ``autotune=True`` a wrapper on CPU tensors runs its plain version, so
it must equal the reference's autotuned Pallas kernel in interpret mode on
the same numpy inputs.
"""

import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.core import build_engine as ref_build_engine  # noqa: E402
from repro.core.colorsets import split_tables  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.coloring import coloring_numpy  # noqa: E402
from repro.kernels import autotune as ref_autotune  # noqa: E402
from repro.kernels.ema.ops import ema as ref_ema  # noqa: E402
from repro.kernels.spmm import ops as ref_spmm  # noqa: E402
from repro.resilience.degradation import (  # noqa: E402
    DegradationState as RefDegradationState)
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.core.engines import build_engine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.ema import ops as ema_ops  # noqa: E402
from repro_torch.kernels.spmm import ops as spmm_ops  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.resilience.degradation import DegradationState  # noqa: E402
from repro_torch.service.cache import EngineCache  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_cache():
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _count(name, kind):
    snap = metrics.get_registry().snapshot()["counters"]
    return snap.get(f'{name}{{kind="{kind}"}}', 0.0)


# ------------------------------------------------------------ the sweep
def test_sweep_picks_the_fastest_and_caches_it():
    calls = {c: 0 for c in ("slow", "fast", "mid")}
    delay = {"slow": 4e-3, "fast": 0.0, "mid": 2e-3}

    def make(c):
        def run():
            calls[c] += 1
            time.sleep(delay[c])
        return run

    hits = _count("autotune_cache_hits_total", "stand_in")
    misses = _count("autotune_cache_misses_total", "stand_in")
    key = ("stand_in", (4, 12, 100), "torch.float32", "cpu", "")
    assert autotune.autotune(key, ("slow", "fast", "mid"), make,
                             reps=3) == "fast"
    # one warm call and three timed, each candidate
    assert calls == {"slow": 4, "fast": 4, "mid": 4}
    assert autotune.cache_info() == {key: "fast"}
    assert _count("autotune_cache_misses_total", "stand_in") == misses + 1
    # the second call is a hit: nothing runs
    assert autotune.autotune(key, ("slow", "fast", "mid"), make) == "fast"
    assert calls == {"slow": 4, "fast": 4, "mid": 4}
    assert _count("autotune_cache_hits_total", "stand_in") == hits + 1


def test_a_failing_candidate_raises_and_nothing_is_cached():
    def make(c):
        def run():
            if c == "bad":
                raise RuntimeError("launch refused")
        return run

    key = ("stand_in", (1,), "torch.float32", "cpu", "")
    with pytest.raises(RuntimeError, match="launch refused"):
        autotune.autotune(key, ("ok", "bad"), make)
    assert key not in autotune.cache_info()
    with pytest.raises(ValueError, match="no candidate"):
        autotune.autotune(key, (), make)


def test_keys_of_dtypes_and_devices_do_not_collide(monkeypatch):
    winners = iter([2, 4, 8, 16])
    seen = []

    def run_with(c):
        seen.append(c)

    def sweep(m):
        # each sweep's first candidate wins when every run costs the same
        first = next(winners)
        return autotune.spmm_c_block(m, run_with, kind="bsr",
                                     operand=(3, 40), candidates=(first,))

    f32 = torch.zeros((4, 12, 50))
    bf16 = f32.to(torch.bfloat16)
    assert sweep(f32) == 2
    assert sweep(bf16) == 4            # a bf16 sweep never reuses f32's
    monkeypatch.setattr(autotune, "device_name", lambda dev: "card B")
    assert sweep(f32) == 8             # nor one card another's
    keys = list(autotune.cache_info())
    assert len(keys) == 3 and len({k[3] for k in keys}) == 2
    assert {k[4] for k in keys} == {"cpu", "card B"}
    # the reorder and the operand are key parts too
    assert autotune.spmm_c_block(f32, run_with, kind="bsr", operand=(3, 40),
                                 reorder="rcm", candidates=(16,)) == 16
    assert autotune.spmm_c_block(f32, run_with, kind="bsr", operand=(3, 40),
                                 reorder="rcm", candidates=(32,)) == 16
    assert len(autotune.cache_info()) == 4


def test_default_shapes_come_first():
    assert autotune.SPMM_C_BLOCK_CANDIDATES[0] == spmm_ops.BSR_ROWS_DEFAULT
    assert set(autotune.SPMM_C_BLOCK_CANDIDATES) == set(spmm_ops.BSR_ROWS)
    assert autotune.GATHER_BLOCK_CANDIDATES[0] == \
        spmm_ops.GATHER_DESTS_DEFAULT
    assert set(autotune.GATHER_BLOCK_CANDIDATES) == \
        set(spmm_ops.GATHER_DESTS)
    assert autotune.EMA_BLOCK_CANDIDATES[0] == (0, 32)     # staged default
    assert (8, 256) in autotune.EMA_BLOCK_CANDIDATES       # direct default


# ------------------------------------------------ the wrappers' own checks
@pytest.mark.parametrize("rows,want", [
    (1, (32, 2)), (12, (32, 2, 4, 8, 16)), (48, (32, 2, 4, 8, 16, 64)),
    (504, (32, 2, 4, 8, 16, 64))])
def test_bsr_shapes_follow_the_rows(rows, want):
    assert spmm_ops.bsr_shapes(rows, autotune.SPMM_C_BLOCK_CANDIDATES) == want


def test_bsr_shapes_respect_the_grid():
    # 65,535 row blocks: 300,000 rows cannot run 2 or 4 to a block
    assert spmm_ops.bsr_shapes(300_000, autotune.SPMM_C_BLOCK_CANDIDATES) \
        == (32, 8, 16, 64)
    assert spmm_ops.bsr_shapes(12, (3, 128)) == ()


@pytest.mark.parametrize("k,t,ta,path", [
    (12, 7, 6, "staged"),      # u12 node 6: S = 792, c_a + c_p = 936
    (10, 10, 5, "direct"),     # a census root: S = 1
    (5, 3, 1, "staged"),       # S = 10 > 8
    (4, 3, 1, "direct"),       # S = 4
])
def test_ema_shapes_keep_the_path(k, t, ta, path):
    from math import comb
    ia, _ = (torch.as_tensor(a) for a in split_tables(k, t, ta))
    c_a, c_p = comb(k, ta), comb(k, t - ta)
    m_a, y_p = torch.zeros((2, c_a, 64)), torch.zeros((2, c_p, 64))
    assert ema_ops.ema_path(c_a, c_p, ia.shape[0], torch.float32) == path
    shapes = ema_ops.ema_shapes(m_a, y_p, ia)
    assert shapes and all((s == 0) == (path == "staged") for s, _ in shapes)
    assert shapes[0] == ((0, 32) if path == "staged" else (8, 256))


def test_ema_shapes_drop_slices_that_do_not_fit():
    # c_a + c_p = 1,000 rows: 64-column f32 slices need 256,000 bytes
    ia = torch.zeros((20, 3), dtype=torch.int32)
    m_a, y_p = torch.zeros((1, 900, 8)), torch.zeros((1, 100, 8))
    assert ema_ops.ema_shapes(m_a, y_p, ia) == ((0, 32), (0, 16))
    assert ema_ops.ema_shapes(m_a.bfloat16(), y_p.bfloat16(), ia) == (
        (0, 32), (0, 16), (0, 64))
    # a direct row of L = 2,000 terms: 16 rows need 256,000 bytes
    ia = torch.zeros((1, 2000), dtype=torch.int32)
    assert ema_ops.ema_shapes(m_a, y_p, ia) == ((8, 256), (4, 256))


def test_gather_shapes():
    g = generators.rmat(8, 32, seed=2)
    prep = spmm_ops.prepare(g, "gather", device="cpu")
    assert spmm_ops.gather_shapes(prep, autotune.GATHER_BLOCK_CANDIDATES) \
        == (128, 32, 64)
    assert spmm_ops.gather_shapes(prep, (96,)) == ()


# ------------------------------------------- against the reference
def _rand(rng, shape):
    return rng.integers(0, 4, size=shape).astype(np.float32)


def test_autotuned_ema_on_cpu_equals_reference_autotuned_pallas():
    ref_autotune.clear_cache()
    rng = np.random.default_rng(1)
    m_a, y_p = _rand(rng, (10, 300)), _rand(rng, (10, 300))
    ia, ip = split_tables(5, 4, 2)
    want = ref_ema(jnp.asarray(m_a), jnp.asarray(y_p), jnp.asarray(ia),
                   jnp.asarray(ip), use_pallas=True, autotune=True)
    sweeps = ema_ops.ema.sweep_launches
    got = ema_ops.ema(torch.as_tensor(m_a), torch.as_tensor(y_p),
                      torch.as_tensor(ia, dtype=torch.int32),
                      torch.as_tensor(ip, dtype=torch.int32), autotune=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0)
    # on the CPU the plain version runs: no sweep, nothing cached
    assert ema_ops.ema.sweep_launches == sweeps
    assert autotune.cache_info() == {}


@pytest.mark.parametrize("method", ["bsr", "gather"])
def test_autotuned_spmm_on_cpu_equals_reference_autotuned_pallas(method):
    ref_autotune.clear_cache()
    rng = np.random.default_rng(2)
    g = generators.erdos_renyi(300, 6.0, seed=3)
    g_ref = ref_gen.erdos_renyi(300, 6.0, seed=3)
    m = _rand(rng, (2, 10, g.n))
    ref_prep = ref_spmm.prepare(g_ref, f"pallas_{method}", interpret=True)
    want = ref_spmm.spmm(jnp.asarray(m), ref_prep, autotune=True)
    got = spmm_ops.spmm(torch.as_tensor(m),
                        spmm_ops.prepare(g, method, device="cpu"),
                        autotune=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0)
    assert autotune.cache_info() == {}


@pytest.mark.parametrize("spmm_method", ["bsr", "gather"])
def test_autotuned_engine_equals_reference_autotuned_engine(spmm_method):
    ref_autotune.clear_cache()
    g = generators.erdos_renyi(50, 4.0, seed=4)
    g_ref = ref_gen.erdos_renyi(50, 4.0, seed=4)
    colors = coloring_numpy(0, 0, g.n, 5)
    ref = ref_build_engine(g_ref, "u5", "pgbsc", use_pallas_ema=True,
                           autotune_blocks=True)
    want, _ = ref.count_colorful(colors)
    eng = build_engine(g, "u5", "pgbsc", autotune_blocks=True,
                       spmm_method=spmm_method, device="cpu")
    assert eng.autotune_blocks
    got, _ = eng.count_colorful(torch.as_tensor(np.array(colors)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_engine_cache_tells_tuned_from_untuned():
    g = generators.erdos_renyi(50, 4.0, seed=4)
    cache = EngineCache()
    plain = cache.get(g, "u5", device="cpu")
    tuned = cache.get(g, "u5", device="cpu", autotune_blocks=True)
    assert tuned is not plain and tuned.autotune_blocks \
        and not plain.autotune_blocks
    assert cache.get(g, "u5", device="cpu", autotune_blocks=True) is tuned
    assert cache.stats()["builds"] == 2


def test_count_passes_engine_keywords():
    from repro_torch import api
    g = generators.erdos_renyi(50, 4.0, seed=4)
    q = api.compile_query(g, api.CountQuery(templates="u5", max_iters=2),
                          device="cpu", engine_kw={"autotune_blocks": True})
    assert q.engine.autotune_blocks
    tuned = api.count(g, "u5", max_iters=2, device="cpu",
                      engine_kw={"autotune_blocks": True})
    plain = api.count(g, "u5", max_iters=2, device="cpu")
    assert tuned.estimate == plain.estimate


def test_ladder_drops_autotune_at_level_one():
    base = {"fuse_spmm_ema": True, "autotune_blocks": True,
            "spmm_method": "bsr"}
    clk = [0.0]
    lad = DegradationState(step_after=1, cooldown_s=10.0,
                           clock=lambda: clk[0])
    ref = RefDegradationState(step_after=1, cooldown_s=10.0,
                              clock=lambda: clk[0])
    assert lad.apply(base) == base
    assert lad.on_failure() and ref.on_failure()
    assert lad.level_name == ref.level_name == "unfused"
    kw, ref_kw = lad.apply(base), ref.apply(base)
    assert "autotune_blocks" not in kw and "autotune_blocks" not in ref_kw
    assert kw["fuse_spmm_ema"] is False


# ------------------------------------------------------------- roofline
@pytest.mark.parametrize("seconds,peak_flops,peak_bw", [
    (1e-3, 51.2e12, 3.0e12), (2.5e-2, 60e12, 2.4e12), (0.0, 1e12, 1e9)])
def test_kernel_roofline_gives_the_reference_numbers(seconds, peak_flops,
                                                     peak_bw):
    b, e, n, c_a, c_p, s, l = 4, 4_190_208, 1 << 20, 12, 792, 924, 6
    flops = roofline.spmm_ema_flops(b, e, n, c_p, s, l)
    assert flops == ref_roofline.spmm_ema_flops(b, e, n, c_p, s, l)
    for fused in (True, False):
        for item in (4, 2):
            got = roofline.spmm_ema_hbm_bytes(b, n, c_a, c_p, s, 4 * e, item,
                                              fused=fused, adj_passes=2)
            assert got == ref_roofline.spmm_ema_hbm_bytes(
                b, n, c_a, c_p, s, 4 * e, item, fused=fused, adj_passes=2)
    hbm = roofline.spmm_ema_hbm_bytes(b, n, c_a, c_p, s, 4 * e, 4,
                                      fused=True)
    args = ("fused", flops, hbm, seconds, peak_flops, peak_bw)
    got = roofline.KernelRoofline(*args)
    want = ref_roofline.KernelRoofline(*args)
    assert got.as_dict() == want.as_dict()
    assert (got.bound, got.roof_fraction, got.oi) == (
        want.bound, want.roof_fraction, want.oi)
    # the port's one addition: the least time at these peaks, which the
    # reference's fraction is the ratio of to the measured time
    assert got.bound_seconds == max(hbm / peak_bw, flops / peak_flops)
    if seconds > 0:
        assert got.bound_seconds / seconds == pytest.approx(
            want.roof_fraction, rel=1e-12)
