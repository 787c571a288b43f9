"""The port's optimizer against the JAX package's ``optim/optimizer.py``.

``TestAdamW``'s four cases of ``tests/test_optim.py`` re-run on the port;
one step, then 20, of :class:`AdamW` against ``adamw_update`` from carried
parameters, gradients and state (f32, and with a bf16 parameter whose
moments stay f32), parameters ``rtol 1e-6`` after one step and ``1e-5``
after 20; the cosine schedule; ``compress_int8`` exactly; and
``compressed_psum`` in gloo ranks started through ``launch/ranks.run_all``
(so no process group outlives a test): at world size 1 against the
reference's single-device ``shard_map``, at 2 and 4 against a numpy
reckoning of the reference's formula, and the 50-step error-feedback
convergence.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.optim import optimizer as ref_opt  # noqa: E402
from repro_torch.interop import (adamw_state_from_arrays,  # noqa: E402
                                 params_to_arrays)
from repro_torch.launch.ranks import run_all  # noqa: E402
from repro_torch.optim.optimizer import (AdamW, AdamWConfig,  # noqa: E402
                                         clip_by_global_norm, compress_int8,
                                         cosine_schedule, decompress_int8)

SRC = str(Path(__file__).resolve().parents[1] / "src")


class TestAdamW:
    def test_quadratic_converges(self):
        cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, clip_norm=100.0)
        w = nn.Parameter(torch.tensor([5.0, -3.0]))
        opt = AdamW([w], cfg)
        for _ in range(150):
            opt.zero_grad()
            torch.sum(w ** 2).backward()
            opt.step()
        assert torch.sum(w ** 2).item() < 1e-2

    def test_clip(self):
        clipped, norm = clip_by_global_norm([torch.tensor([3.0, 4.0])], 1.0)
        assert norm.item() == pytest.approx(5.0)
        np.testing.assert_allclose(clipped[0].numpy(), [0.6, 0.8],
                                   rtol=1e-5)

    def test_schedule_shape(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
        s = [cosine_schedule(cfg, t).item() for t in (0, 5, 10, 55, 100)]
        assert s[0] == 0.0
        assert s[1] == pytest.approx(0.5)
        assert s[2] == pytest.approx(1.0)
        assert 0 < s[3] < 1.0
        assert s[4] == pytest.approx(0.0, abs=1e-6)

    def test_weight_decay_shrinks(self):
        cfg = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5,
                          total_steps=10)
        w = nn.Parameter(torch.tensor([10.0]))
        w.grad = torch.tensor([0.0])
        AdamW([w], cfg).step()
        assert w.item() < 10.0


@pytest.mark.parametrize("warmup", [10, 0])
@pytest.mark.parametrize("t", [0, 5, 10, 55, 100])
def test_cosine_schedule_equals_reference(t, warmup):
    cfg = AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=100)
    ref_cfg = ref_opt.AdamWConfig(lr=3e-3, warmup_steps=warmup,
                                  total_steps=100)
    got = cosine_schedule(cfg, t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.item(), float(ref_opt.cosine_schedule(ref_cfg, jnp.float32(t))),
        rtol=1e-6, atol=1e-12)


# ------------------------------------------- AdamW against adamw_update
class _Params(nn.Module):
    """Parameters named as the reference's pytree
    ``{"a": (5, 7), "b": {"w": (3,), "h": (4, 4)}}``."""

    def __init__(self, arrays, h_dtype):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(arrays["a"]))
        self.b = nn.Module()
        self.b.w = nn.Parameter(torch.tensor(arrays["b"]["w"]))
        self.b.h = nn.Parameter(torch.tensor(arrays["b"]["h"]).to(h_dtype))


def _tree(rng, scale=1.0, positive=False):
    shapes = {"a": (5, 7), "b": {"w": (3,), "h": (4, 4)}}

    def draw(shape):
        a = rng.normal(size=shape).astype(np.float32) * scale
        return np.abs(a) if positive else a
    return jax.tree_util.tree_map(draw, shapes,
                                  is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("steps", [1, 20])
@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_adamw_steps_equal_adamw_update(steps, h_dtype):
    """From a carried state at step 7 (clipping active, weight decay on),
    the port's steps equal the reference's on the same gradients."""
    rng = np.random.default_rng(0)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0, warmup_steps=10,
                  total_steps=40)
    params = _tree(rng)
    state = {"mu": _tree(rng, 0.1), "nu": _tree(rng, 0.01, positive=True),
             "step": np.int32(7)}
    jdt = jnp.bfloat16 if h_dtype == "bfloat16" else jnp.float32
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    ref_p["b"]["h"] = ref_p["b"]["h"].astype(jdt)
    ref_s = jax.tree_util.tree_map(jnp.asarray, state)
    model = _Params(params, getattr(torch, h_dtype))
    opt = AdamW(model.named_parameters(), AdamWConfig(**cfg_kw))
    adamw_state_from_arrays(opt, state)
    # eager, as written: under jit XLA drops the bf16 rounding of the
    # clipped gradient (a bf16 -> f32 convert pair)
    ref_cfg = ref_opt.AdamWConfig(**cfg_kw)
    tol = 1e-6 if steps == 1 else 1e-5
    for _ in range(steps):
        grads = _tree(rng, 0.5)
        ref_g = jax.tree_util.tree_map(jnp.asarray, grads)
        ref_g["b"]["h"] = ref_g["b"]["h"].astype(jdt)
        ref_p, ref_s, metrics = ref_opt.adamw_update(ref_cfg, ref_p, ref_g,
                                                     ref_s)
        for name, p in model.named_parameters():
            g = grads
            for k in name.split("."):
                g = g[k]
            p.grad = torch.tensor(g).to(p.dtype)
        opt.step()
        np.testing.assert_allclose(opt.last_grad_norm.item(),
                                   float(metrics["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(opt.last_lr.item(), float(metrics["lr"]),
                                   rtol=1e-6)
    assert opt.param_groups[0]["step"] == int(ref_s["step"]) == 7 + steps
    got = params_to_arrays(model)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), ref_p)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=tol, atol=1e-7),
        got, want)
    assert model.b.h.dtype == getattr(torch, h_dtype)
    for name, p in model.named_parameters():
        for k in ("mu", "nu"):
            assert opt.state[p][k].dtype == torch.float32
            ref = ref_s[k]
            for part in name.split("."):
                ref = ref[part]
            # a moment near 0 is a difference of terms ~max|moment|
            ref = np.asarray(ref)
            np.testing.assert_allclose(opt.state[p][k].numpy(), ref,
                                       rtol=tol, atol=tol * np.abs(ref).max())


def test_adamw_state_needs_named_parameters():
    w = nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="named_parameters"):
        adamw_state_from_arrays(AdamW([w]), {"mu": {}, "nu": {},
                                             "step": 0})


# ------------------------------------------------------------ compression
INT8_CASES = {
    "normal": np.random.default_rng(0).normal(size=(1000,)),
    "halves": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.5]),
    "zeros": np.zeros(9),
    "wide": np.random.default_rng(1).normal(size=(17, 33)) * 1e4,
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_compress_int8_equals_reference(case):
    g = INT8_CASES[case].astype(np.float32)
    q, s = compress_int8(torch.tensor(g))
    ref_q, ref_s = ref_opt.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert s.item() == float(ref_s)
    back = decompress_int8(q, s)
    assert np.abs(back.numpy() - g).max() <= s.item() * 0.5 + 1e-6
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_opt.decompress_int8(ref_q, ref_s)))


def test_compress_int8_takes_bf16():
    g = np.random.default_rng(2).normal(size=(64,)).astype(np.float32)
    q, s = compress_int8(torch.tensor(g).to(torch.bfloat16))
    ref_q, ref_s = ref_opt.compress_int8(jnp.asarray(g).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert s.item() == float(ref_s)


# ---------------------------------------------- compressed_psum in ranks
_RANK = r'''
import json, sys, warnings
warnings.filterwarnings("ignore", category=FutureWarning)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, inp, out = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch.optim.optimizer import compressed_psum
data = np.load(inp)
grads = {k: torch.tensor(data[f"g{rank}_{k}"]) for k in ("w", "v")}
res = {k: torch.tensor(data[f"r{rank}_{k}"]) for k in ("w", "v")}
summed, new_res = compressed_psum(grads, res)
lst, lst_res = compressed_psum([grads["w"], grads["v"]],
                               [res["w"], res["v"]])
arrays = {f"s_{k}": summed[k].numpy() for k in summed}
arrays.update({f"n_{k}": new_res[k].numpy() for k in new_res})
arrays["list_equal"] = np.array(
    all(torch.equal(a, summed[k]) and torch.equal(b, new_res[k])
        for a, b, k in zip(lst, lst_res, ("w", "v"))))
if world == 1:
    # the error-feedback convergence of tests/test_optim.py
    g = {"w": torch.tensor([0.3, -0.7, 1.234, 0.001])}
    r = {"w": torch.zeros(4)}
    acc = np.zeros(4)
    for _ in range(50):
        o, r = compressed_psum(g, r)
        acc += o["w"].numpy()
    arrays["ef_mean"] = acc / 50
np.savez(out, **arrays)
dist.destroy_process_group()
'''

WORLDS = (1, 2, 4)


def _inputs(world):
    rng = np.random.default_rng(world)
    out = {}
    for r in range(world):
        out[f"g{r}_w"] = rng.normal(size=(64,)).astype(np.float32)
        out[f"g{r}_v"] = (rng.normal(size=(5, 3)) * 1e-3).astype(np.float32)
        out[f"r{r}_w"] = (np.zeros(64) if world == 1 else rng.normal(
            size=(64,)) * 0.01).astype(np.float32)
        out[f"r{r}_v"] = (rng.normal(size=(5, 3)) * 1e-5).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def psum_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("psum")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmds = {}
    for world in WORLDS:
        np.savez(tmp / f"in{world}.npz", **_inputs(world))
        for r in range(world):
            cmds[f"w{world}r{r}"] = [
                sys.executable, "-c", _RANK, str(r), str(world),
                str(tmp / f"store{world}"), str(tmp / f"in{world}.npz"),
                str(tmp / f"w{world}r{r}.npz")]
    done = run_all(cmds, env, tmp, 240)
    for name, (rc, _, err) in done.items():
        assert rc == 0, f"{name} exited {rc}:\n{err[-4000:]}"
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in cmds}


def _reckon(inputs, world, k):
    """The reference's formula (``optimizer.py:97-119``) in numpy f32."""
    xs = [inputs[f"g{r}_{k}"] + inputs[f"r{r}_{k}"] for r in range(world)]
    amax = max(np.abs(x).max() for x in xs)
    scale = np.float32(max(amax, np.float32(1e-12))) / np.float32(127.0)
    qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in xs]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0)
    return (total.astype(np.float32) * scale,
            [x - q.astype(np.float32) * scale for x, q in zip(xs, qs)])


def test_compressed_psum_at_world_one_equals_shard_map(psum_runs):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_mesh
    inputs = _inputs(1)
    g = {k: jnp.asarray(inputs[f"g0_{k}"]) for k in ("w", "v")}
    r = {k: jnp.asarray(inputs[f"r0_{k}"]) for k in ("w", "v")}
    mesh = make_mesh((1,), ("d",))
    out, res = shard_map(lambda g, r: ref_opt.compressed_psum(g, "d", r),
                         mesh=mesh, in_specs=(P(), P()),
                         out_specs=(P(), P()), check_rep=False)(g, r)
    got = psum_runs["w1r0"]
    for k in ("w", "v"):
        np.testing.assert_allclose(got[f"s_{k}"], np.asarray(out[k]),
                                   rtol=1e-7, atol=0)
        np.testing.assert_allclose(got[f"n_{k}"], np.asarray(res[k]),
                                   rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["s_w"], inputs["g0_w"], atol=0.05)
    assert np.abs(got["n_w"]).max() < 0.05
    assert bool(got["list_equal"])


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_across_ranks_equals_formula(psum_runs, world):
    inputs = _inputs(world)
    for k in ("w", "v"):
        summed, res = _reckon(inputs, world, k)
        for r in range(world):
            got = psum_runs[f"w{world}r{r}"]
            np.testing.assert_allclose(got[f"s_{k}"], summed, rtol=1e-7,
                                       atol=0)
            np.testing.assert_allclose(got[f"n_{k}"], res[r], rtol=1e-6,
                                       atol=1e-9)
            assert bool(got["list_equal"])


def test_error_feedback_converges_over_steps(psum_runs):
    """Repeated compression of a constant gradient: error feedback makes
    the time-average exact."""
    np.testing.assert_allclose(psum_runs["w1r0"]["ef_mean"],
                               [0.3, -0.7, 1.234, 0.001], atol=2e-3)
