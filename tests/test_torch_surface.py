"""The port's package surface: ``repro_torch.graph`` and
``repro_torch.obs`` export the JAX package's names (the graph package
less ``EdgeChunks``, the TPU's padded edge operand, which the port's
``GatherPrep`` replaced), and the port's own counting examples run on the
CPU at a cut size."""

import importlib.util
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import repro.graph as ref_graph  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro_torch.graph as graph  # noqa: E402
import repro_torch.obs as obs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_graph_exports_the_reference_names_but_edge_chunks():
    assert graph.__all__ == [n for n in ref_graph.__all__
                             if n != "EdgeChunks"]
    assert not hasattr(graph, "EdgeChunks")


def test_obs_exports_the_reference_names():
    assert obs.__all__ == ref_obs.__all__


@pytest.mark.parametrize("pkg", ["graph", "obs"])
def test_every_exported_name_resolves(pkg):
    mod = {"graph": graph, "obs": obs}[pkg]
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name


def test_graph_exports_build_the_reference_graphs():
    import numpy as np
    for make in ("grid_2d", "erdos_renyi", "rmat"):
        args = {"grid_2d": (5, 6), "erdos_renyi": (80, 4.0),
                "rmat": (7,)}[make]
        got, want = getattr(graph, make)(*args), getattr(ref_graph, make)(
            *args)
        assert isinstance(got, graph.Graph)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)


def test_obs_exports_record_spans_and_metrics():
    old = obs.get_registry()
    obs.set_registry(obs.MetricsRegistry())
    try:
        obs.counter("surface_test_total").inc(2)
        with obs.span("surface.test"):
            pass
        snap = obs.snapshot()
        prom = obs.to_prometheus()
    finally:
        obs.set_registry(old)
    obs.validate_snapshot(snap)
    assert "surface_test_total" in prom


def test_quickstart_example_runs_on_the_cpu(capsys):
    out = _example("quickstart_torch").main(
        ["--device", "cpu", "--n", "100", "--iters", "4"])
    text = capsys.readouterr().out
    assert "SpMM column-ops" in text and "service r0003" in text
    fused, solo = out["spmm_cols"]
    assert 0 < fused < solo
    # two spellings of path4 share one sample stream
    assert out["service"][1] == out["service"][2]
    assert out["service_stats"]["engine_cache"]["builds"] == 2
    assert all(v > 0 for k, v in out.items() if k in ("u3", "u5", "chair"))


def test_distributed_counting_example_runs_gloo_ranks(tmp_path, capsys):
    rc = _example("distributed_counting_torch").main(
        ["--device", "cpu", "--mesh", "2,1,2", "--iters", "8", "--n", "60",
         "--ledger", str(tmp_path / "ledger"), "--timeout", "240"])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert "iterations done=8" in text and "exact=" in text
    # each rank kept its own ledger
    assert sorted(p.name for p in (tmp_path / "ledger").iterdir()) == [
        f"rank{r}" for r in range(4)]
