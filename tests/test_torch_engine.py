"""The whole slice: the port's PGBSC engine and ``count`` against the JAX
package's, on the same graphs, templates and colorings.

The reference engine runs its kernel configuration — ``pallas_bsr`` SpMM,
Pallas eMA and fused SpMM->eMA, in interpret mode — and the port's engine
runs on the CPU (the kernels' plain versions). f32 totals and root tables
agree to ``rtol=1e-6`` (integer counts below 2^24: exact in practice);
bf16 storage to ``1e-2`` relative, as the reference's ``TestBf16Engine``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as ref_api  # noqa: E402
from repro.core.engines import CountingEngine as RefEngine  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.coloring import coloring_numpy  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import executor as pexec  # noqa: E402
from repro_torch.core.engines import CountingEngine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402

GRAPHS = {
    "grid16": (lambda: generators.grid_2d(16, 16),
               lambda: ref_gen.grid_2d(16, 16)),
    "er": (lambda: generators.erdos_renyi(150, 5.0, seed=4),
           lambda: ref_gen.erdos_renyi(150, 5.0, seed=4)),
}
TEMPLATES = ["u5", "u7", "u12"]
KERNEL_CONFIG = dict(spmm_method="pallas_bsr", use_pallas_ema=True,
                     fuse_spmm_ema=True, plan="optimized")


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _engines(gname, tname, **kw):
    g, g_ref = (f() for f in GRAPHS[gname])
    return (CountingEngine(g, tname, plan="optimized", device="cpu", **kw),
            RefEngine(g_ref, tname, **KERNEL_CONFIG))


def _colorings(n, k, b=3, seed=5):
    return np.stack([coloring_numpy(seed, i, n, k) for i in range(b)])


@pytest.mark.parametrize("tname", TEMPLATES)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_count_colorful_batch_matches_reference(gname, tname):
    eng, ref = _engines(gname, tname)
    cols = _colorings(eng.g.n, eng.k)
    tot, root = eng.count_colorful_batch(torch.as_tensor(cols))
    want_tot, want_root = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(tot.numpy(), np.asarray(want_tot), rtol=1e-6)
    np.testing.assert_allclose(root.numpy(), np.asarray(want_root),
                               rtol=1e-6)


@pytest.mark.parametrize("tname", TEMPLATES)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_estimate_samples_equal_reference(gname, tname):
    eng, ref = _engines(gname, tname)
    got = eng.estimate(6, seed=11)
    want = ref.estimate(6, seed=11)
    assert got["samples"] == want["samples"]
    assert got["count"] == want["count"]


@pytest.mark.parametrize("tname", TEMPLATES)
def test_api_count_equals_reference(tname):
    g, g_ref = (f() for f in GRAPHS["grid16"])
    got = api.count(g, tname, max_iters=12, seed=2, device="cpu")
    want = ref_api.count(g_ref, tname, max_iters=12, seed=2)
    assert (got.estimate, got.stderr, got.iterations, got.target_met) == (
        want.estimate, want.stderr, want.iterations, want.target_met)


def test_api_count_adaptive_stopping_matches_reference():
    g, g_ref = (f() for f in GRAPHS["er"])
    got = api.count(g, "u5", rel_stderr=0.05, max_iters=40, round_size=4,
                    seed=1, device="cpu")
    want = ref_api.count(g_ref, "u5", rel_stderr=0.05, max_iters=40,
                         round_size=4, seed=1)
    assert (got.estimate, got.iterations, got.target_met) == (
        want.estimate, want.iterations, want.target_met)


@pytest.mark.parametrize("tname", TEMPLATES)
def test_bf16_storage_within_tolerance(tname):
    eng, ref = _engines("er", tname, dtype=torch.bfloat16)
    cols = _colorings(eng.g.n, eng.k, b=2)
    got, root = eng.count_colorful_batch(torch.as_tensor(cols))
    assert root.dtype == torch.bfloat16 and got.dtype == torch.float32
    want, _ = ref.count_colorful_batch(jnp.asarray(cols))
    want = np.asarray(want, np.float64)
    rel = np.abs(got.numpy() - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max() <= 1e-2


@pytest.mark.parametrize("batch_size", [1, 2, 5])
def test_batch_chunking_does_not_change_totals(batch_size):
    eng, _ = _engines("grid16", "u7")
    cols = torch.as_tensor(_colorings(eng.g.n, eng.k, b=5))
    whole, _ = eng.count_colorful_batch(cols)
    chunked, _ = eng.count_colorful_batch(cols, batch_size=batch_size)
    assert torch.equal(whole, chunked)
    one, root = eng.count_colorful(cols[3])
    assert one.item() == whole[3].item() and root.shape == (1, eng.g.n)


def test_fused_and_unfused_walks_agree():
    g = generators.erdos_renyi(150, 5.0, seed=4)
    cols = torch.as_tensor(_colorings(g.n, 12))
    fused = CountingEngine(g, "u12", plan="optimized", device="cpu")
    plain = CountingEngine(g, "u12", plan="optimized", device="cpu",
                           fuse_spmm_ema=False)
    assert fused.schedule.fused and not plain.schedule.fused
    torch.testing.assert_close(fused.count_colorful_batch(cols)[0],
                               plain.count_colorful_batch(cols)[0],
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("tname", TEMPLATES)
def test_measured_peak_within_model(tname):
    g = generators.erdos_renyi(150, 5.0, seed=4)
    eng = CountingEngine(g, tname, plan="optimized", device="cpu",
                         batch_size=3)
    eng.count_colorful_batch(torch.as_tensor(_colorings(g.n, eng.k)))
    model = pexec.peak_table_bytes(eng.plan, eng.k, g.n, batch=3,
                                   schedule=eng.schedule)
    assert 0 < eng.measured_peak_bytes <= model


def test_release_rebuilds_on_next_call():
    eng, _ = _engines("grid16", "u5")
    cols = torch.as_tensor(_colorings(eng.g.n, eng.k))
    before, _ = eng.count_colorful_batch(cols)
    eng.release()
    after, _ = eng.count_colorful_batch(cols)
    assert torch.equal(before, after)


@pytest.mark.parametrize("kw,match", [
    (dict(engine="fascia"), "fascia"),
    (dict(spmm_method="segment"), "segment"),
    (dict(engine="pfascia"), "pfascia"),
])
def test_unported_options_raise(kw, match):
    """The three options that raised before the baselines and the XLA
    backends were ported now run, and equal the reference's engine with
    the same option on the same colorings."""
    g = generators.grid_2d(4, 4)
    eng = CountingEngine(g, "u5", device="cpu", **kw)
    assert match in (eng.engine, eng.spmm_method)
    ref = RefEngine(ref_gen.grid_2d(4, 4), "u5", **kw)
    cols = _colorings(g.n, 5)
    got, root = eng.count_colorful_batch(torch.as_tensor(cols))
    want, want_root = ref.count_colorful_batch(jnp.asarray(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(root.numpy(), np.asarray(want_root),
                               rtol=1e-6)


def test_multi_template_and_chunking_raise():
    g = generators.grid_2d(16, 16)
    # bundles are ported: they raise only where the reference does, on
    # mixed template sizes and on the plain (un-deduplicated) plan
    with pytest.raises(ValueError, match="equal-k"):
        CountingEngine(g, ["u5", "u7"], plan="dedup", device="cpu")
    with pytest.raises(ValueError, match="plain"):
        CountingEngine(g, ["u5", "u5"], device="cpu")


def test_u10_budget_runs_chunked():
    g = generators.grid_2d(16, 16)
    # u10's unfused plain plan at half its batch-1 peak makes the memory
    # model chunk a node's passive axis, and the engine runs it chunked
    # (tests/test_torch_chunking.py holds the counts against the reference)
    eng = CountingEngine(g, "u10", plan="plain", device="cpu",
                         fuse_spmm_ema=False, memory_budget_bytes=309_248)
    assert eng.schedule.chunk_map and eng.batch_size == 1
