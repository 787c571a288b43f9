"""The port's package surface: ``repro_torch.graph`` and
``repro_torch.obs`` export the JAX package's names (the graph package
less ``EdgeChunks``, the TPU's padded edge operand, which the port's
``GatherPrep`` replaced), the port's own counting examples run on the
CPU at a cut size, its LM serving example runs beside the reference's,
and its LM training example trains, checkpoints and resumes."""

import importlib.util
from pathlib import Path

import pytest
import torch

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


def test_serve_lm_example_equals_the_reference_decode(capsys):
    """``examples/serve_lm_torch.py`` on the CPU beside the reference's
    ``examples/serve_lm.py`` loop: the reference's parameters and prompt,
    chunked prefill, then a greedy decode whose tokens the port is
    teacher-forced on, so a near-tie in an argmax cannot fork the runs.
    Every step's logits within ``rtol 1e-5`` of the largest magnitude."""
    import dataclasses

    import numpy as np
    from repro.configs import get_config
    from repro.data.synthetic import lm_token_stream
    from repro.models.transformer import (init_decode_cache, init_lm,
                                          lm_decode_step, lm_prefill_chunked)
    jnp = jax.numpy
    ex = _example("serve_lm_torch")
    fields = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "d_head", "sliding_window", "global_every",
              "remat")
    cfg = dataclasses.replace(
        get_config("gemma3-1b").model, param_dtype=jnp.float32,
        **{f: getattr(ex.MODEL, f) for f in fields})
    params = init_lm(jax.random.PRNGKey(0), cfg)
    prompt = lm_token_stream(jax.random.PRNGKey(1), ex.BATCH, ex.PROMPT,
                             cfg.vocab_size)
    cache = init_decode_cache(cfg, ex.BATCH, ex.S_MAX, dtype=jnp.float32)
    logits, cache = jax.jit(lambda p, t, c: lm_prefill_chunked(
        p, cfg, t, c, chunk=ex.CHUNK))(params, prompt, cache)
    want_prefill = np.asarray(logits)
    decode = jax.jit(lambda p, c, t: lm_decode_step(p, cfg, c, t))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    fed, want_steps = [], []
    for _ in range(ex.GEN):
        fed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok)
        want_steps.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    fed = np.concatenate(fed, axis=1)

    out = ex.main(["--device", "cpu"],
                  params=jax.tree_util.tree_map(np.asarray, params),
                  prompt=np.array(prompt), forced=fed)
    assert "generated 16 tokens x 4 requests" in capsys.readouterr().out
    np.testing.assert_array_equal(out["tokens"].numpy(), fed)
    assert out["len"] == int(cache["len"]) == ex.PROMPT + ex.GEN
    pairs = [(out["prefill_logits"], want_prefill)] + list(
        zip(out["step_logits"], want_steps))
    for got, want in pairs:
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def test_serve_lm_example_decodes_greedily_on_its_own():
    out = _example("serve_lm_torch").main(["--device", "cpu"])
    steps = out["step_logits"]
    # each fed token after the first is the argmax of the step before
    for i in range(1, len(steps)):
        assert torch.equal(out["tokens"][:, i:i + 1],
                           steps[i - 1][:, -1:].argmax(-1).to(torch.int32))


@pytest.fixture(scope="module")
def one_thread():
    """The training example's small products on one thread: beside other
    test processes, a thread pool each spends its time waiting."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def straight_train_run(tmp_path_factory, one_thread):
    """``examples/train_lm_torch.py``: 30 steps on the CPU, straight
    through, checkpointing every 10."""
    ckpt = tmp_path_factory.mktemp("straight")
    return _example("train_lm_torch").main(
        ["--steps", "30", "--device", "cpu", "--ckpt", str(ckpt),
         "--ckpt-every", "10"])


def test_train_lm_example_loss_falls(straight_train_run):
    losses = straight_train_run["losses"]
    assert sorted(losses) == list(range(30))
    first = sum(losses[i] for i in range(5)) / 5
    last = sum(losses[i] for i in range(25, 30)) / 5
    assert last < first - 0.1, (first, last)


def test_train_lm_example_resumes_bit_for_bit(straight_train_run, tmp_path,
                                              monkeypatch):
    """Killed at step 20 (after the checkpoint of step 20), then resumed
    to 30: every parameter, moment and the step equal the straight run's
    bit for bit."""
    ex = _example("train_lm_torch")
    real = ex.batch_for

    def dies_at_20(it, *args):
        if it == 20:
            raise KeyboardInterrupt("killed")
        return real(it, *args)
    monkeypatch.setattr(ex, "batch_for", dies_at_20)
    argv = ["--steps", "30", "--device", "cpu", "--ckpt", str(tmp_path),
            "--ckpt-every", "10"]
    with pytest.raises(KeyboardInterrupt):
        ex.main(argv)
    monkeypatch.setattr(ex, "batch_for", real)
    out = ex.main(argv + ["--resume"])
    assert sorted(out["losses"]) == list(range(20, 30))
    for i in range(20, 30):
        assert out["losses"][i] == straight_train_run["losses"][i]
    from repro_torch.train.step import state_leaves
    got = state_leaves(out["state"])
    want = state_leaves(straight_train_run["state"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        a, b = a(), b()
        assert a.dtype == b.dtype and torch.equal(a, b), p
