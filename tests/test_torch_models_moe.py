"""The port's ``moe_ffn`` against the JAX package's ``models/moe.py``, on
the CPU, from the reference's own ``init_moe`` parameters on the same
numpy input: groups 1, 2 and 3 on token counts 3 divides and does not
(``pick_groups`` falls back to a divisor), capacity factors 1.25 and 0.5
(tokens drop), shared experts on and off, top-k ties (lower expert index
first, as ``jax.lax.top_k``), and the output, the aux loss and every
gradient. f32: outputs ``rtol 1e-5`` of the largest magnitude, gradients
``1e-4`` of each leaf's largest magnitude.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.interop import _load  # noqa: E402
from repro_torch.models import moe  # noqa: E402

D, FF, E, K = 16, 24, 8, 2
GEN = torch.Generator().manual_seed(0)


def _close(got, want, rtol, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * np.abs(want).max(initial=0.0), (what, err)


def _params(n_shared, seed=0):
    p = jax.tree_util.tree_map(np.asarray, ref_moe.init_moe(
        jax.random.PRNGKey(seed), D, FF, E, n_shared, jnp.float32))
    port = _load(moe.MoE(D, FF, E, n_shared, dtype=torch.float32,
                         device="cpu", generator=GEN), p)
    return p, port


def _run_both(p, port, x, **kw):
    want, want_aux = jax.jit(lambda pp, xx: ref_moe.moe_ffn(
        pp, xx, top_k=K, **kw))(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, aux = moe.moe_ffn(port, xt, top_k=K, **kw)
    return (want, want_aux), (got, aux, xt)


# (batch, seq): 12 tokens (3 divides) and 14 (it does not: 3 -> 2 groups)
TOKENS = {"t12": (2, 6), "t14": (2, 7)}


@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("tokens", sorted(TOKENS))
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_ffn_and_gradients_equal_reference(groups, tokens, cf, n_shared):
    p, port = _params(n_shared)
    b, s = TOKENS[tokens]
    x = np.random.default_rng(1).normal(size=(b, s, D)).astype(np.float32)
    kw = dict(capacity_factor=cf, groups=groups)
    (want, want_aux), (got, aux, xt) = _run_both(p, port, x, **kw)
    _close(got, want, 1e-5, "out")
    _close(aux, want_aux, 1e-5, "aux")

    w = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)

    def loss(params, xx):
        out, a = ref_moe.moe_ffn(params, xx, top_k=K, **kw)
        return jnp.sum(out * w) + 0.5 * a
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    (torch.sum(got * torch.from_numpy(w)) + 0.5 * aux).backward()
    _close(xt.grad, gx, 1e-4, "x")
    for name, q in port.named_parameters():
        want_g = gp
        for k in name.split("."):
            want_g = want_g[k]
        _close(q.grad if q.grad is not None else torch.zeros_like(q),
               want_g, 1e-4, name)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_capacity_drops_tokens_as_the_reference(cf):
    """At cf 0.5 the per-group capacity is ``int(0.5 * 16 * 2 / 8)`` = 2
    slots an expert: slots past it contribute nothing, in both."""
    p, port = _params(0, seed=3)
    x = np.random.default_rng(4).normal(size=(1, 16, D)).astype(np.float32)
    (want, _), (got, _, _) = _run_both(p, port, x, capacity_factor=cf)
    _close(got, want, 1e-5)
    if cf == 0.5:
        # some token lost both of its slots and outputs zeros
        dropped = np.all(np.asarray(want)[0] == 0, axis=-1)
        assert dropped.any()
        assert np.all(got.detach().numpy()[0][dropped] == 0)


def test_pick_groups_is_the_reference_rule():
    for req in range(1, 9):
        for n in range(1, 30):
            assert moe.pick_groups(req, n) == ref_moe._pick_groups(req, n)


@pytest.mark.parametrize("tie", ["all_equal", "two_columns"])
def test_top_k_ties_take_the_lower_expert_first(tie):
    """Equal router probabilities: ``jax.lax.top_k`` takes the lower
    index first, and so does the port's stable sort."""
    p, port = _params(0, seed=5)
    router = p["router"].copy()
    if tie == "all_equal":
        router[:] = 0.0
    else:                      # experts 5 and 2 always tie, and lead
        router[:, 2] = router[:, 5] = np.abs(router).max(1) * 4
    p = dict(p, router=router)
    port.router.data = torch.from_numpy(router.copy())
    x = np.abs(np.random.default_rng(6).normal(size=(1, 9, D))
               ).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x[0]) @ router, axis=-1)
    want_idx = np.asarray(jax.lax.top_k(probs, K)[1])
    got_idx = moe.route(port, torch.from_numpy(x), K)[2][0].numpy()
    np.testing.assert_array_equal(got_idx, want_idx)
    expect = [0, 1] if tie == "all_equal" else [2, 5]
    assert (got_idx == expect).all()
    (want, want_aux), (got, aux, _) = _run_both(p, port, x)
    _close(got, want, 1e-5)
    _close(aux, want_aux, 1e-5)
