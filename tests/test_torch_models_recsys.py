"""The port's AutoInt and EmbeddingBag against the JAX package's
``models/recsys.py``, on the CPU: ``embedding_bag`` in its three modes
(the reference's own test, an empty bag, weights), then
``autoint_forward``, ``user_embedding``, ``retrieval_scores``,
``autoint_loss`` and every gradient at ``reduced_config("autoint")``
from the reference's ``init_autoint`` parameters on the reference's own
batches; and ``recsys_batch`` against ``make_batch`` (shapes, dtypes,
ranges). f32: ``rtol 1e-5`` of the largest magnitude, gradients ``1e-4``
of each leaf's largest magnitude.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import recsys as ref_rs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.synthetic import recsys_batch  # noqa: E402
from repro_torch.interop import (autoint_from_params,  # noqa: E402
                                 params_to_arrays)
from repro_torch.models import recsys as rs  # noqa: E402


def _close(got, want, rtol=1e-5, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * np.abs(want).max(initial=0.0) + 1e-12, (what, err)


# ------------------------------------------------------------ EmbeddingBag
def test_embedding_bag_modes_as_the_reference_test():
    """``tests/test_models_smoke.py::test_embedding_bag_modes`` on the
    port."""
    table = torch.from_numpy(np.random.default_rng(0).normal(size=(10, 4))
                             .astype(np.float32))
    idx = torch.tensor([[0, 1, -1], [2, -1, -1], [-1, -1, -1]])
    s = rs.embedding_bag(table, idx, mode="sum")
    torch.testing.assert_close(s[0], table[0] + table[1], rtol=1e-6, atol=0)
    assert (s[2] == 0).all()
    m = rs.embedding_bag(table, idx, mode="mean")
    torch.testing.assert_close(m[0], (table[0] + table[1]) / 2, rtol=1e-6,
                               atol=0)
    mx = rs.embedding_bag(table, idx, mode="max")
    torch.testing.assert_close(mx[1], table[2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_and_gradient_equal_reference(mode, weighted):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(12, 5)).astype(np.float32)
    idx = rng.integers(-1, 12, (6, 4)).astype(np.int32)
    idx[0] = -1                                   # an empty bag
    idx[1] = [3, 3, 3, -1]                        # ties under max
    w = rng.uniform(0.5, 2, (6, 4)).astype(np.float32) if weighted else None
    want = ref_rs.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                None if w is None else jnp.asarray(w), mode)
    tt = torch.from_numpy(table).requires_grad_(True)
    got = rs.embedding_bag(tt, torch.from_numpy(idx),
                           None if w is None else torch.from_numpy(w), mode)
    _close(got, want)
    assert (got[0] == 0).all()
    g = rng.normal(size=want.shape).astype(np.float32)
    want_g = jax.grad(lambda t: jnp.sum(ref_rs.embedding_bag(
        t, jnp.asarray(idx), None if w is None else jnp.asarray(w), mode)
        * g))(jnp.asarray(table))
    (got * torch.from_numpy(g)).sum().backward()
    _close(tt.grad, want_g, 1e-5)


# ------------------------------------------------------------------ AutoInt
@pytest.fixture(scope="module")
def autoint():
    rarch = ref_configs.reduced_config("autoint")
    arch = configs.reduced_config("autoint")
    params = jax.tree_util.tree_map(
        np.asarray, ref_rs.init_autoint(jax.random.PRNGKey(0), rarch.model))
    # a bias that is not zero, so its gradient and value count
    params["bias"] = np.asarray(0.3, np.float32)
    model = autoint_from_params(arch.model, params, device="cpu")
    return rarch, arch, params, model


def _batch(rarch, cell, seed=3):
    ref = make_batch(rarch, cell, jax.random.PRNGKey(seed))
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


def test_params_round_trip(autoint):
    _, _, params, model = autoint
    back = params_to_arrays(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    assert back["bias"].shape == ()
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bags", [True, False])
def test_autoint_forward_and_user_embedding_equal_reference(autoint, bags):
    rarch, _, params, model = autoint
    ref, batch = _batch(rarch, "smoke_train")
    if not bags:
        ref, batch = dict(ref), dict(batch)
        ref.pop("bag_ids")
        batch.pop("bag_ids")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _close(rs.user_embedding(model, batch),
           ref_rs.user_embedding(jp, rarch.model, ref))
    got = rs.autoint_forward(model, batch)
    assert got.dtype == torch.float32
    _close(got, ref_rs.autoint_forward(jp, rarch.model, ref))


def test_retrieval_scores_equal_reference(autoint):
    rarch, _, params, model = autoint
    ref, batch = _batch(rarch, "smoke_retrieval", seed=4)
    want = ref_rs.retrieval_scores(
        jax.tree_util.tree_map(jnp.asarray, params), rarch.model, ref,
        ref["candidates"], ref["retrieval_proj"])
    got = rs.retrieval_scores(model, batch, batch["candidates"],
                              batch["retrieval_proj"])
    assert got.shape == (2, 128)
    _close(got, want)


def test_autoint_loss_and_gradients_equal_reference(autoint):
    rarch, _, params, model = autoint
    model = copy.deepcopy(model)
    ref, batch = _batch(rarch, "smoke_train", seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_rs.autoint_loss(p, rarch.model, ref)))(jp)
    loss = rs.autoint_loss(model, batch)
    _close(loss, want)
    loss.backward()
    grads = copy.deepcopy(model)
    for p, q in zip(grads.parameters(), model.parameters()):
        p.data = q.grad
    got_g = params_to_arrays(grads)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(got_g),
            jax.tree_util.tree_leaves(want_g)):
        _close(torch.from_numpy(np.asarray(a)), b, 1e-4, str(path))


def test_build_autoint_draws_the_reference_distributions():
    cfg = configs.reduced_config("autoint").model
    m = rs.build_autoint(cfg, device="cpu")
    assert m.tables.shape == (cfg.n_sparse, cfg.vocab_size, cfg.embed_dim)
    assert abs(m.tables.std().item() / 0.05 - 1) < 0.05
    assert m.bias.shape == () and m.bias.item() == 0.0
    assert len(m.attn) == cfg.n_attn_layers
    assert m.attn[0].wq.shape == (cfg.d_attn, cfg.n_heads,
                                  cfg.d_attn // cfg.n_heads)


# ------------------------------------------------------------------ batches
@pytest.mark.parametrize("cell", ["smoke_train", "smoke_retrieval"])
def test_recsys_batch_matches_make_batch_in_kind(cell):
    rarch = ref_configs.reduced_config("autoint")
    arch = configs.reduced_config("autoint")
    ref = make_batch(rarch, cell, jax.random.PRNGKey(0))
    got = recsys_batch(arch, cell, 0, device="cpu")
    assert sorted(got) == sorted(ref)
    m = arch.model
    for k, v in ref.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
    assert got["sparse_ids"].min() >= 0
    assert got["sparse_ids"].max() < m.vocab_size
    assert got["bag_ids"].min() >= -1 and got["bag_ids"].max() < m.vocab_size
    if cell == "smoke_train":
        assert set(got["labels"].unique().tolist()) <= {0.0, 1.0}
    else:
        assert abs(got["retrieval_proj"].std().item() / 0.05 - 1) < 0.2
    # the same seed gives the same batch; the model runs on it
    again = recsys_batch(arch, cell, 0, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    model = rs.build_autoint(m, device="cpu")
    assert rs.autoint_forward(model, got).shape == (got["dense"].shape[0],)


def test_recsys_batch_rates():
    """Bernoulli(0.3) labels, and ``-1`` padding at 1 in V + 1, as
    ``randint(-1, V)`` gives."""
    arch = configs.reduced_config("autoint")
    cell = dataclasses.replace(arch.cell("smoke_train"),
                               dims={"batch": 20_000})
    big = dataclasses.replace(arch, cells=(cell,))
    got = recsys_batch(big, "smoke_train", 1, device="cpu")
    assert abs(got["labels"].mean().item() - 0.3) < 0.02
    pad = (got["bag_ids"] == -1).float().mean().item()
    assert abs(pad * (arch.model.vocab_size + 1) - 1) < 0.1
    full = recsys_batch(configs.get_config("autoint"), "serve_p99", 0,
                        device="cpu")
    assert "labels" not in full and full["dense"].shape == (512, 13)
