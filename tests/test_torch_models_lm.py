"""The port's LM layers and models against the JAX package's
``models/layers.py`` and ``models/transformer.py``, on the CPU.

Both packages run the same numpy inputs on the same parameters (the
reference's own, carried in with ``repro_torch.interop``; norm scales are
perturbed so they count): ``rms_norm``, ``rope``, each attention branch
(full, blocked online softmax at S = 30 with 8-token chunks, which pads,
and the unrolled blocks) with GQA groups 1, 2 and 4, a window with
``is_global`` 0 and 1, and QK-norm; ``decode_attention`` and
``prefill_attention`` with their cache writes; ``mlp_swiglu``. Then
``lm_forward``, ``lm_loss`` and every gradient against ``jax.grad`` for
all five reduced LM ids. Tolerances: f32 forward ``rtol 1e-5`` of the
largest magnitude; gradients ``1e-4`` of each leaf's largest magnitude;
bf16 parameters ``1e-2`` relative, the reference's bf16 tolerance.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import (_load, lm_from_params,  # noqa: E402
                                 params_to_arrays)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.moe import route  # noqa: E402

LM_IDS = ["smollm-360m", "llama3-8b", "gemma3-1b", "deepseek-moe-16b",
          "qwen3-moe-30b-a3b"]
CPU = torch.device("cpu")
GEN = torch.Generator().manual_seed(0)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close_to_largest(got, want, rtol=1e-5, atol=0.0, what=""):
    """Every element within ``atol + rtol * max|want|``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    bound = atol + rtol * np.abs(want).max(initial=0.0)
    assert err <= bound, f"{what}: {err} over {bound}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb_scales(tree, seed=11):
    """Norm scales of ones become 1 + 0.1 * normal (same on both sides)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        a = np.asarray(node)
        if key == "scale":
            a = (a.astype(np.float32)
                 + 0.1 * rng.normal(size=a.shape).astype(np.float32)
                 ).astype(a.dtype)
        return a
    return walk(tree)


# ---------------------------------------------------------------- layers
def test_rms_norm_equals_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.normal(size=24)).astype(np.float32)
    want = ref_layers.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                               1e-5)
    p = L.RMSNorm(24, dtype=torch.float32, device=CPU)
    p.scale.data = _t(scale)
    close_to_largest(L.rms_norm(p, _t(x), 1e-5), want, 1e-6)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_b = ref_layers.rms_norm({"scale": jnp.asarray(scale)}, xb)
    got_b = L.rms_norm(p, _t(x).bfloat16())
    assert got_b.dtype == torch.bfloat16
    close_to_largest(got_b, np.asarray(want_b, np.float32), 1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 1_000_000.0])
def test_rope_equals_reference_and_interleaves(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = (np.arange(40) + 1000)[None, :]
    want = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.rope(_t(x), _t(pos), theta)
    close_to_largest(got, want, 1e-5)
    # pairs are (0, 1), (2, 3), ...: rotating position 1 by theta**0
    # mixes x[0] and x[1] only
    e = np.zeros((1, 1, 1, 16), np.float32)
    e[..., 0] = 1.0
    r = L.rope(_t(e), torch.tensor([[1]]), theta)[0, 0, 0]
    assert abs(r[1].item() - np.sin(1.0)) < 1e-6 and r[2:].abs().max() == 0


def _attn_params(d, h, hkv, dh, qk_norm, seed=0):
    p = _numpy(ref_layers.init_attention(jax.random.PRNGKey(seed), d, h, hkv,
                                         dh, jnp.float32, qk_norm))
    p = _perturb_scales(p)
    port = _load(L.Attention(d, h, hkv, dh, dtype=torch.float32, device=CPU,
                             generator=GEN, use_qk_norm=qk_norm), p)
    return p, port


# (n_kv for 4 query heads -> GQA groups 4 / 2 / 1)
GROUPS = {"g1": 4, "g2": 2, "g4": 1}
# (window, is_global)
MASKS = {"causal": (None, None), "local": (8, 0.0), "global": (8, 1.0),
         "window_no_flag": (8, None)}
# (S, q_chunk, kv_chunk, unroll): full, blocked padded, blocked uneven,
# unrolled
BRANCHES = {"full": (30, 1024, 1024, False), "blocked": (30, 8, 8, False),
            "blocked_uneven": (30, 8, 12, False),
            "unrolled": (512, 1024, 1024, True)}


# the unrolled branch at one GQA width
ATTN_CASES = [(b, g, m) for b in sorted(BRANCHES) if b != "unrolled"
              for g in sorted(GROUPS) for m in sorted(MASKS)] + \
    [("unrolled", "g2", m) for m in ("causal", "global", "local")]


@pytest.mark.parametrize("branch,groups,mask", ATTN_CASES)
def test_attention_branches_equal_reference(branch, groups, mask):
    s, qc, kc, unroll = BRANCHES[branch]
    d, h, dh = 32, 4, 8
    hkv = GROUPS[groups]
    window, flag = MASKS[mask]
    qk_norm = groups == "g2"
    p, port = _attn_params(d, h, hkv, dh, qk_norm)
    x = np.random.default_rng(2).normal(size=(2, s, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv=hkv, d_head=dh, theta=10_000.0,
              window=window, use_qk_norm=qk_norm, q_chunk=qc, kv_chunk=kc,
              unroll_chunks=unroll)
    want = jax.jit(functools.partial(ref_layers.attention, **kw))(
        p, jnp.asarray(x),
        is_global=None if flag is None else jnp.float32(flag))
    got = L.attention(port, _t(x), is_global=flag, **kw)
    close_to_largest(got, want, 1e-5, what=branch)


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("mask", ["causal", "local", "global"])
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_equals_reference(groups, mask, cache_dtype):
    d, h, dh, s_max, at = 32, 4, 8, 24, 13
    hkv = GROUPS[groups]
    window, flag = MASKS[mask]
    qk_norm = groups == "g4"
    p, port = _attn_params(d, h, hkv, dh, qk_norm, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, d)).astype(np.float32)
    ck = rng.normal(size=(2, s_max, hkv, dh)).astype(np.float32)
    cv = rng.normal(size=(2, s_max, hkv, dh)).astype(np.float32)
    jdt = getattr(jnp, cache_dtype)
    tdt = getattr(torch, cache_dtype)
    kw = dict(n_heads=h, n_kv=hkv, d_head=dh, theta=10_000.0, window=window,
              use_qk_norm=qk_norm)
    want, wk, wv = jax.jit(functools.partial(
        ref_layers.decode_attention, **kw))(
        p, jnp.asarray(x), jnp.asarray(ck).astype(jdt),
        jnp.asarray(cv).astype(jdt), jnp.int32(at),
        is_global=None if flag is None else jnp.float32(flag))
    tk, tv = _t(ck).to(tdt), _t(cv).to(tdt)
    got, gk, gv = L.decode_attention(port, _t(x), tk, tv,
                                     torch.tensor(at, dtype=torch.int32),
                                     is_global=flag, shard_hints={}, **kw)
    assert gk is tk and gv is tv           # written in place
    tol = 1e-5 if cache_dtype == "float32" else 1e-2
    close_to_largest(got, want, tol)
    close_to_largest(gk, np.asarray(wk, np.float32), tol)
    close_to_largest(gv, np.asarray(wv, np.float32), tol)


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("mask", ["causal", "local", "global"])
@pytest.mark.parametrize("c0", [0, 8, 16])
def test_prefill_attention_equals_reference(groups, mask, c0):
    d, h, dh, s_max, cs = 32, 4, 8, 32, 8
    hkv = GROUPS[groups]
    window, flag = MASKS[mask]
    p, port = _attn_params(d, h, hkv, dh, groups == "g1", seed=5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, cs, d)).astype(np.float32)
    ck = rng.normal(size=(2, s_max, hkv, dh)).astype(np.float32)
    cv = rng.normal(size=(2, s_max, hkv, dh)).astype(np.float32)
    kw = dict(n_heads=h, n_kv=hkv, d_head=dh, theta=10_000.0, window=window,
              use_qk_norm=groups == "g1")
    want, wk, wv = jax.jit(functools.partial(
        ref_layers.prefill_attention, c0=c0, **kw))(
        p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        is_global=None if flag is None else jnp.float32(flag))
    got, gk, gv = L.prefill_attention(port, _t(x), _t(ck), _t(cv), c0,
                                      is_global=flag, **kw)
    close_to_largest(got, want, 1e-5)
    close_to_largest(gk, wk, 1e-6)
    close_to_largest(gv, wv, 1e-6)


def test_mlp_swiglu_equals_reference():
    p = _numpy(ref_layers.init_mlp(jax.random.PRNGKey(7), 24, 40,
                                   jnp.float32))
    port = _load(L.MLP(24, 40, dtype=torch.float32, device=CPU,
                       generator=GEN), p)
    x = np.random.default_rng(8).normal(size=(3, 5, 24)).astype(np.float32)
    close_to_largest(L.mlp_swiglu(port, _t(x)),
                     ref_layers.mlp_swiglu(p, jnp.asarray(x)), 1e-5)


# ---------------------------------------------------------------- models
@functools.lru_cache(maxsize=None)
def _ref_params(arch_id, dtype):
    rcfg = dataclasses.replace(ref_configs.reduced_config(arch_id).model,
                               param_dtype=getattr(jnp, dtype))
    return _perturb_scales(_numpy(ref_tf.init_lm(jax.random.PRNGKey(0),
                                                 rcfg)))


def _lm(arch_id, dtype="float32", remat=False):
    """(reference cfg, carried params, port model) at reduced_config."""
    rcfg = ref_configs.reduced_config(arch_id).model
    cfg = configs.reduced_config(arch_id).model
    rcfg = dataclasses.replace(rcfg, param_dtype=getattr(jnp, dtype),
                               remat=remat)
    cfg = dataclasses.replace(cfg, param_dtype=getattr(torch, dtype),
                              remat=remat)
    params = copy.deepcopy(_ref_params(arch_id, dtype))
    return rcfg, params, lm_from_params(cfg, params, device="cpu")


def _tokens(cfg, b=2, s=32, seed=9):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


def _grads(model):
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad if q.grad is not None else torch.zeros_like(q)
    return params_to_arrays(g)


def _assert_trees_close(got, want, rtol, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_trees_close(got[k], want[k], rtol, f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_trees_close(a, b, rtol, f"{path}/{i}")
    else:
        close_to_largest(got, np.asarray(want, np.float32), rtol, 1e-12,
                         what=path)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_params_round_trip_through_the_reference_layout(arch_id):
    _, params, model = _lm(arch_id)
    back = params_to_arrays(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_lm_from_params_raises_on_a_missing_leaf():
    _, params, _ = _lm("smollm-360m")
    del params["layers"]["ln1"]
    with pytest.raises(ValueError, match="parameter trees differ"):
        lm_from_params(configs.reduced_config("smollm-360m").model, params,
                       device="cpu")


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_forward_and_loss_equal_reference(arch_id):
    rcfg, params, model = _lm(arch_id)
    toks = _tokens(rcfg)
    x, y = toks[:, :-1], toks[:, 1:]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, want_aux = jax.jit(lambda p, t: ref_tf.lm_forward(p, rcfg, t))(
        jp, jnp.asarray(x))
    got, aux = tf.lm_forward(model, _t(x))
    assert got.dtype == torch.float32
    close_to_largest(got, want, 1e-5, what="logits")
    close_to_largest(aux, want_aux, 1e-5, what="aux")
    # blocked attention (8-token chunks) gives the same logits
    blocked, _ = tf.lm_forward(model, _t(x), q_chunk=8, kv_chunk=8)
    close_to_largest(blocked, want, 1e-5, what="blocked")
    want_loss = jax.jit(lambda p, t, u: ref_tf.lm_loss(p, rcfg, t, u))(
        jp, jnp.asarray(x), jnp.asarray(y))
    close_to_largest(tf.lm_loss(model, _t(x), _t(y)), want_loss, 1e-5)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_loss_gradients_equal_jax_grad(arch_id):
    rcfg, params, model = _lm(arch_id, remat=arch_id == "llama3-8b")
    toks = _tokens(rcfg, seed=10)
    x, y = toks[:, :-1], toks[:, 1:]
    want = _numpy(jax.jit(jax.grad(
        lambda p: ref_tf.lm_loss(p, rcfg, jnp.asarray(x), jnp.asarray(y))))(
            jax.tree_util.tree_map(jnp.asarray, params)))
    tf.lm_loss(model, _t(x), _t(y)).backward()
    _assert_trees_close(_grads(model), want, 1e-4)


# (arch id, which block, window flag): one block of each kind
BF16_BLOCKS = {"llama3": ("llama3-8b", "layers", 1.0),
               "gemma3_local": ("gemma3-1b", "layers", 0.0),
               "gemma3_global": ("gemma3-1b", "layers", 1.0),
               "deepseek_front": ("deepseek-moe-16b", "dense_front", 1.0),
               "deepseek_moe": ("deepseek-moe-16b", "layers", 1.0),
               "qwen3_moe": ("qwen3-moe-30b-a3b", "layers", 1.0)}


@pytest.mark.parametrize("case", sorted(BF16_BLOCKS))
def test_block_in_bf16_within_reference_tolerance(case):
    """One bf16 block on one bf16 input: within ``1e-2`` of the largest
    magnitude (one chain of bf16 roundings on each side), and an MoE
    block routes every token to the reference's experts."""
    arch_id, stack, flag = BF16_BLOCKS[case]
    rcfg, params, model = _lm(arch_id, dtype="bfloat16")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    if stack == "layers":
        ref_p = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    else:
        ref_p = jp["dense_front"][0]
    block = getattr(model, stack)[0]
    x = (np.random.default_rng(13).normal(size=(2, 32, rcfg.d_model)) * 0.5
         ).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = jax.jit(ref_tf._block, static_argnums=0)(
        rcfg, ref_p, xj, jnp.float32(flag))
    with torch.no_grad():
        got, _ = block(_t(x).bfloat16(), flag)
    assert got.dtype == torch.bfloat16
    if "moe" in ref_p:
        def ref_ids(p, xx):
            h = xx + ref_layers.attention(
                p["attn"], ref_layers.rms_norm(p["ln1"], xx),
                n_heads=rcfg.n_heads, n_kv=rcfg.n_kv_heads,
                d_head=rcfg.head_dim, theta=rcfg.rope_theta,
                use_qk_norm=rcfg.use_qk_norm)
            hn = ref_layers.rms_norm(p["ln2"], h)
            probs = jax.nn.softmax(hn.reshape(1, -1, rcfg.d_model).astype(
                jnp.float32) @ p["moe"]["router"], axis=-1)
            return jax.lax.top_k(probs, rcfg.moe.top_k)[1]
        want_ids = np.asarray(jax.jit(ref_ids)(ref_p, xj))
        with torch.no_grad():
            th = _t(x).bfloat16()
            th = th + L.attention(
                block.attn, L.rms_norm(block.ln1, th), n_heads=rcfg.n_heads,
                n_kv=rcfg.n_kv_heads, d_head=rcfg.head_dim,
                theta=rcfg.rope_theta, use_qk_norm=rcfg.use_qk_norm)
            got_ids = route(block.moe, L.rms_norm(block.ln2, th).reshape(
                1, -1, rcfg.d_model), rcfg.moe.top_k)[2]
        np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    close_to_largest(got, np.asarray(want, np.float32), 1e-2)


@pytest.mark.parametrize("arch_id", ["llama3-8b", "smollm-360m",
                                     "gemma3-1b"])
def test_lm_forward_in_bf16_near_the_reference(arch_id):
    """The whole bf16 model (two blocks and the head) against the
    reference's bf16 forward: within ``1e-2`` of the largest magnitude
    (0.72-0.81% here). The port rounds where XLA rounds at its default
    precision: ``silu`` as four rounded ops, and the mid-block residual
    sum kept in f32 until the block's end (XLA elides its bf16 rounding).
    MoE models are left out: a bf16 rounding flips a near-tied route in
    either package."""
    rcfg, params, model = _lm(arch_id, dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    x = _tokens(rcfg, seed=12)[:, :-1]
    want, _ = ref_tf.lm_forward(
        jax.tree_util.tree_map(jnp.asarray, params), rcfg, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tf.lm_forward(model, _t(x))
    close_to_largest(got, want, 1e-2)


# The bf16 forward above with every op of the reference rounded: XLA runs
# with ``--xla_allow_excess_precision=false``, so every op rounds to bf16
# as its HLO says (at default precision the CPU backend elides the
# rounding of the mid-block residual sum), and the port's block rounds
# that sum too, as it did before it followed XLA's default. XLA reads its
# flags when it starts, so this runs in a process of its own.
_ROUNDED_BF16 = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, jax, jax.numpy as jnp
import test_torch_models_lm as T
def _rounded_residual(self, x, h):
    x = x + h
    f, aux = self.ffn(T.L.rms_norm(self.ln2, x, self.cfg.norm_eps))
    return x + f, aux
T.tf.Block._ffn_residual = _rounded_residual
out = {}
for arch_id in sys.argv[2:]:
    rcfg, params, model = T._lm(arch_id, dtype="bfloat16")
    x = T._tokens(rcfg, seed=12)[:, :-1]
    want, _ = T.ref_tf.lm_forward(
        jax.tree_util.tree_map(jnp.asarray, params), rcfg, jnp.asarray(x))
    with torch.no_grad():
        got, _ = T.tf.lm_forward(model, T._t(x))
    want = np.asarray(want, np.float32)
    out[arch_id] = float(np.abs(got.float().numpy() - want).max()
                         / np.abs(want).max())
print(json.dumps(out))
"""
BF16_IDS = ["llama3-8b", "smollm-360m", "gemma3-1b"]


@pytest.fixture(scope="module")
def rounded_bf16_gaps():
    import json
    import os
    import pathlib
    import subprocess
    import sys
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [str(here.parent / "src"), os.environ.get("PYTHONPATH",
                                                             "")]))
    run = subprocess.run([sys.executable, "-c", _ROUNDED_BF16, str(here),
                          *BF16_IDS], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch_id", BF16_IDS)
def test_lm_forward_in_bf16_within_1e2_of_the_bf16_rounded_reference(
        arch_id, rounded_bf16_gaps):
    """With every op rounded on both sides (above), the whole bf16 model
    is within the reference's bf16 tolerance, ``1e-2`` of the largest
    magnitude."""
    assert rounded_bf16_gaps[arch_id] <= 1e-2, rounded_bf16_gaps


def test_moe_router_stays_f32_in_a_bf16_model():
    _, _, model = _lm("qwen3-moe-30b-a3b", dtype="bfloat16")
    moe = model.layers[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.dtype == torch.bfloat16


def test_gemma3_window_flags_are_the_reference_pattern():
    cfg = configs.get_config("gemma3-1b").model
    flags = tf.window_flags(cfg, cfg.n_layers)
    assert [i for i, f in enumerate(flags) if f == 1.0] == [5, 11, 17, 23]
    ds = configs.get_config("deepseek-moe-16b").model
    assert tf.window_flags(ds, 27) == [1.0] * 27
    red = dataclasses.replace(cfg, n_layers=4, first_dense_layers=1)
    assert tf.window_flags(red, 4) == [1.0 if (i + 1) % 6 == 0 else 0.0
                                       for i in range(4)]


def test_build_lm_draws_the_reference_distributions():
    cfg = dataclasses.replace(configs.reduced_config("deepseek-moe-16b").model,
                              d_model=256, vocab_size=2048)
    m = tf.build_lm(cfg, device="cpu")
    d = cfg.d_model
    for name, scale in (("embed", d ** -0.5), ("lm_head", d ** -0.5),
                        ("layers.0.attn.wq", d ** -0.5),
                        ("layers.0.moe.w_down", cfg.d_ff ** -0.5),
                        ("dense_front.0.mlp.w_down", cfg.dense_d_ff ** -0.5)):
        w = dict(m.named_parameters())[name]
        assert abs(w.std().item() / scale - 1) < 0.05, name
    assert (m.ln_f.scale == 1).all()
    # the same generator seed gives the same model
    m2 = tf.build_lm(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))
