"""The port's LM serving path on the CPU: chunked prefill into a KV cache,
batched decode, and ``lm_batch``.

* the three checks of ``tests/test_chunked_prefill.py`` re-run on the
  port (its own parameters, ``build_lm``): chunked-prefill logits equal
  ``lm_forward``'s last chunk, the decode hand-off equals ``lm_forward``
  of the prompt plus the token, and MoE chunked prefill correlates with
  the full forward (> 0.8), with that test's tolerances;
* the port against the reference from carried parameters, the same
  tokens and the same cache state: ``lm_prefill_chunked`` then three
  ``lm_decode_step``s, logits and every cache array, with an f32 cache
  (``rtol 1e-5`` of the largest magnitude) and the reference's default
  bf16 cache (``1e-2``, the reference's bf16 tolerance: a K/V row that
  rounds one bf16 step apart moves the next layer's logits by ~0.3%); a
  decode from a cache
  whose rows are filled and whose ``len`` is half its length
  (``decode_cache_from_arrays``);
* ``lm_batch`` against ``make_batch``: shapes, dtypes, the shifted
  targets, and the decode cache at ``len = s // 2``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.synthetic import lm_batch, lm_token_stream  # noqa: E402
from repro_torch.interop import (decode_cache_from_arrays,  # noqa: E402
                                 decode_cache_to_arrays, lm_from_params)
from repro_torch.models.transformer import (build_lm,  # noqa: E402
                                            init_decode_cache, lm_decode_step,
                                            lm_forward, lm_prefill,
                                            lm_prefill_chunked)

LM_IDS = ["smollm-360m", "llama3-8b", "gemma3-1b", "deepseek-moe-16b",
          "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _setup(arch_id, B=2, S=32):
    cfg = configs.reduced_config(arch_id).model
    model = build_lm(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    return cfg, model, toks


def _close(got, want, rtol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    bound = rtol * np.abs(want).max(initial=0.0)
    assert err <= bound, f"{what}: {err} over {bound}"


# ---------------------------------- tests/test_chunked_prefill.py, on the port
@pytest.mark.parametrize("arch_id", ["smollm-360m", "gemma3-1b"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_matches_full_forward(arch_id, chunk):
    cfg, model, toks = _setup(arch_id)
    B, S = toks.shape
    full, _ = lm_forward(model, toks)
    cache = init_decode_cache(cfg, B, S + 4, dtype=torch.float32,
                              device="cpu")
    out, cache = lm_prefill_chunked(model, toks, cache, chunk=chunk)
    np.testing.assert_allclose(full[:, -chunk:].numpy(), out.numpy(),
                               rtol=2e-4, atol=2e-4)
    assert int(cache["len"]) == S


@pytest.mark.parametrize("arch_id", ["smollm-360m", "gemma3-1b"])
def test_decode_handoff(arch_id):
    cfg, model, toks = _setup(arch_id)
    B, S = toks.shape
    cache = init_decode_cache(cfg, B, S + 4, dtype=torch.float32,
                              device="cpu")
    _, cache = lm_prefill_chunked(model, toks, cache, chunk=8)
    nxt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 1)).astype(np.int32))
    dec, cache = lm_decode_step(model, cache, nxt)
    full, _ = lm_forward(model, torch.cat([toks, nxt], 1))
    np.testing.assert_allclose(full[:, -1:].numpy(), dec.numpy(),
                               rtol=2e-3, atol=2e-3)
    assert int(cache["len"]) == S + 1


@pytest.mark.parametrize("arch_id", ["deepseek-moe-16b",
                                     "qwen3-moe-30b-a3b"])
def test_moe_chunked_runs_and_correlates(arch_id):
    cfg, model, toks = _setup(arch_id)
    B, S = toks.shape
    full, _ = lm_forward(model, toks)
    cache = init_decode_cache(cfg, B, S + 4, dtype=torch.float32,
                              device="cpu")
    out, cache = lm_prefill_chunked(model, toks, cache, chunk=8)
    a, b = full[:, -8:].numpy().ravel(), out.numpy().ravel()
    assert np.isfinite(b).all()
    assert np.corrcoef(a, b)[0, 1] > 0.8
    assert int(cache["len"]) == S


# --------------------------------------------- the port against the reference
def _carried(arch_id, seed=0):
    rcfg = ref_configs.reduced_config(arch_id).model
    cfg = configs.reduced_config(arch_id).model
    params = jax.tree_util.tree_map(
        np.asarray, ref_tf.init_lm(jax.random.PRNGKey(seed), rcfg))
    return rcfg, cfg, params, lm_from_params(cfg, params, device="cpu")


def _compare_cache(got, want, rtol):
    arrays = decode_cache_to_arrays(got)
    assert sorted(arrays) == sorted(want)
    for k in ("k", "v", "k_front", "v_front"):
        _close(arrays[k], np.asarray(want[k], np.float32), rtol, k)
    assert int(arrays["len"]) == int(want["len"])


@pytest.mark.parametrize("arch_id", LM_IDS)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_equal_reference(arch_id, cache_dtype):
    rcfg, cfg, params, model = _carried(arch_id)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    B, S, chunk = 2, 32, 8
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    logit_tol, cache_tol = (1e-5, 1e-5) if cache_dtype == "float32" \
        else (1e-2, 1e-2)
    rc = ref_tf.init_decode_cache(rcfg, B, S + 4,
                                  dtype=getattr(jnp, cache_dtype))
    tc = init_decode_cache(cfg, B, S + 4, dtype=getattr(torch, cache_dtype),
                           device="cpu")
    want, rc = jax.jit(lambda p, t, c: ref_tf.lm_prefill_chunked(
        p, rcfg, t, c, chunk=chunk))(jp, jnp.asarray(toks[:, :S]), rc)
    got, tc2 = lm_prefill_chunked(model, torch.from_numpy(toks[:, :S]), tc,
                                  chunk=chunk)
    assert tc2 is tc                               # filled in place
    _close(got, want, logit_tol, "prefill logits")
    _compare_cache(tc, rc, cache_tol)
    step = jax.jit(lambda p, c, t: ref_tf.lm_decode_step(p, rcfg, c, t))
    for i in range(3):
        tok = toks[:, S + i:S + i + 1]
        want, rc = step(jp, rc, jnp.asarray(tok))
        got, tc = lm_decode_step(model, tc, torch.from_numpy(tok))
        _close(got, want, logit_tol, f"decode {i}")
        _compare_cache(tc, rc, cache_tol)


@pytest.mark.parametrize("arch_id", ["gemma3-1b", "deepseek-moe-16b"])
def test_decode_from_a_carried_cache_state(arch_id):
    """A cache whose rows are all filled (random) and whose ``len`` is half
    its length, as ``make_batch``'s decode cells hand it over: the window
    and the mask past ``len`` both bite."""
    rcfg, cfg, params, model = _carried(arch_id, seed=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(3)
    rc = ref_tf.init_decode_cache(rcfg, 2, 32, dtype=jnp.float32)
    rc = {k: (rng.normal(size=v.shape).astype(np.float32) if v.ndim
              else np.asarray(16, np.int32)) for k, v in rc.items()}
    tc = decode_cache_from_arrays(rc, device="cpu")
    assert tc["len"].dtype == torch.int32 and int(tc["len"]) == 16
    step = jax.jit(lambda p, c, t: ref_tf.lm_decode_step(p, rcfg, c, t))
    rcj = jax.tree_util.tree_map(jnp.asarray, rc)
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        want, rcj = step(jp, rcj, jnp.asarray(tok))
        got, tc = lm_decode_step(model, tc, torch.from_numpy(tok))
        _close(got, want, 1e-5, f"decode {i}")
        _compare_cache(tc, rcj, 1e-5)


def test_decode_cache_round_trips_bf16():
    cfg = configs.reduced_config("deepseek-moe-16b").model
    c = init_decode_cache(cfg, 2, 8, device="cpu")
    assert c["k"].dtype == torch.bfloat16           # the default
    assert c["k"].shape == (cfg.n_layers - 1, 2, 8, cfg.n_kv_heads,
                            cfg.head_dim)
    assert c["k_front"].shape[0] == 1
    c["k"].normal_()
    back = decode_cache_from_arrays(decode_cache_to_arrays(c), device="cpu")
    assert back["k"].dtype == torch.float32
    assert torch.equal(back["k"].bfloat16(), c["k"])


def test_lm_prefill_is_the_forward_logits():
    _, model, toks = _setup("llama3-8b")
    torch.testing.assert_close(lm_prefill(model, toks),
                               lm_forward(model, toks)[0], rtol=0, atol=0)


def test_chunked_prefill_rejects_a_ragged_prompt():
    cfg, model, toks = _setup("smollm-360m", S=20)
    cache = init_decode_cache(cfg, 2, 24, device="cpu")
    with pytest.raises(ValueError, match="multiple of chunk"):
        lm_prefill_chunked(model, toks, cache, chunk=8)


# ------------------------------------------------------------------- batches
@pytest.mark.parametrize("cell", ["smoke_train", "smoke_prefill",
                                  "smoke_decode"])
@pytest.mark.parametrize("arch_id", ["llama3-8b", "deepseek-moe-16b"])
def test_lm_batch_matches_make_batch_in_kind(arch_id, cell):
    rarch = ref_configs.reduced_config(arch_id)
    arch = configs.reduced_config(arch_id)
    ref = make_batch(rarch, cell, jax.random.PRNGKey(0))
    got = lm_batch(arch, cell, 0, device="cpu")
    assert sorted(got) == sorted(ref)
    if "cache" in ref:
        want_c, got_c = ref["cache"], got["cache"]
        assert sorted(got_c) == sorted(want_c)
        for k, v in want_c.items():
            assert tuple(got_c[k].shape) == tuple(v.shape), k
        assert got_c["k"].dtype == arch.model.param_dtype
        s = arch.cell(cell).dims["seq"]
        assert int(got_c["len"]) == int(want_c["len"]) == s // 2
        assert got_c["len"].dtype == torch.int32
        assert got["token"].shape == (2, 1)
        # the model decodes from it
        model = build_lm(arch.model, device="cpu")
        logits, c = lm_decode_step(model, got_c, got["token"])
        assert logits.shape == (2, 1, arch.model.vocab_size)
        assert int(c["len"]) == s // 2 + 1
        return
    for k, v in ref.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert got[k].dtype == torch.int32
        assert 0 <= int(got[k].min()) and int(got[k].max()) < \
            arch.model.vocab_size
    if "targets" in got:
        assert torch.equal(got["tokens"][:, 1:], got["targets"][:, :-1])


def test_token_stream_is_zipf_flavoured():
    toks = lm_token_stream(0, 64, 256, 1000, device="cpu")
    assert toks.dtype == torch.int32 and toks.shape == (64, 256)
    # u**3: P(id < 125) = P(u < 0.5) = 0.5
    assert abs((toks < 125).float().mean().item() - 0.5) < 0.02
    assert torch.equal(toks, lm_token_stream(0, 64, 256, 1000, device="cpu"))
