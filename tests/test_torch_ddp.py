"""The port's DDP step against the JAX package's ``train/ddp.py``.

One JAX process on 4 forced XLA host devices runs the reference's
``build_ddp_step`` (``shard_map`` over ``data``) for 3 steps on reduced
smollm and autoint, compressed and plain; it also keeps each device's
gradients of the first step and the reference's ``compressed_psum`` of
them. Then 4 gloo ranks (``launch/ranks.run_all``, each a fresh
interpreter on a ``FileStore`` under ``tmp_path``) run the port's
``build_ddp_step`` from the same carried state on the same batches, and
its ``compressed_psum`` on the reference's per-device gradients.

Plain DDP is held to the reference within ``1e-5`` of each leaf's
largest magnitude. The compressed all-reduce is bit-equal to the
reference's given the same gradients. In the compressed steps the two
packages' gradients differ by f32 rounding, which now and then moves an
element of ``(g + r) / scale`` across a rounding boundary: that element's
sum then differs by one quantization step (``scale``, 1/127 of the
largest ``|g + r|`` on the group) and its residual by the same step, until
error feedback gives it back. So the compressed step holds the
parameters and loss within ``1e-5``, the moments within ``2 / 127`` of
each leaf's largest magnitude, and each residual element within one step
(twice the reference leaf's largest residual), with under 1% of the
elements a step apart (0.1% at most here).
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.data import synthetic as ref_data  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro.train.ddp import init_ddp_state as ref_init_ddp  # noqa: E402
from repro_torch.launch.ranks import run_all  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD = 4
STEPS = 3
ARCHS = {"smollm-360m": {"seq": 32, "batch": 8},
         "autoint": {"batch": 16}}
CASES = [(a, c) for a in ARCHS for c in (True, False)]

_JAX = r'''
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro import configs
from repro.optim.optimizer import compressed_psum
from repro.train.ddp import build_ddp_step
from repro.train.step import loss_fn_for
inp, out = sys.argv[1], sys.argv[2]
with open(inp, "rb") as f:
    data = pickle.load(f)
mesh = Mesh(np.array(jax.devices()), ("data",))
results = {}
for (arch_id, compress), case in data["cases"].items():
    arch = data["archs"][arch_id]
    state = jax.tree_util.tree_map(jnp.asarray, case["state"])
    fn = jax.jit(build_ddp_step(arch, mesh, compress=compress))
    metrics = []
    for batch in case["batches"]:
        state, m = fn(state, jax.tree_util.tree_map(jnp.asarray, batch))
        metrics.append({k: float(v) for k, v in m.items()})
    res = {"metrics": metrics,
           "state": jax.tree_util.tree_map(np.asarray, state)}
    if compress:
        loss_fn = loss_fn_for(arch)
        params = jax.tree_util.tree_map(jnp.asarray,
                                        case["state"]["params"])
        batch = jax.tree_util.tree_map(jnp.asarray, case["batches"][0])

        def local(p, b):
            g = jax.grad(loss_fn)(p, b)
            return jax.tree_util.tree_map(lambda x: x[None], g)
        bspec = jax.tree_util.tree_map(lambda _: P("data"), batch)
        pspec = jax.tree_util.tree_map(lambda _: P(), params)
        per = shard_map(local, mesh=mesh, in_specs=(pspec, bspec),
                        out_specs=jax.tree_util.tree_map(
                            lambda _: P("data"), params),
                        check_rep=False)(params, batch)
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)

        def psum(g, r):
            s, nr = compressed_psum(
                jax.tree_util.tree_map(lambda x: x[0], g), "data", r)
            return s, jax.tree_util.tree_map(lambda x: x[None], nr)
        summed, new_r = shard_map(
            psum, mesh=mesh, in_specs=(jax.tree_util.tree_map(
                lambda _: P("data"), params), pspec),
            out_specs=(pspec, jax.tree_util.tree_map(
                lambda _: P("data"), params)), check_rep=False)(per, zeros)
        res["per_grads"] = [np.asarray(x)
                            for x in jax.tree_util.tree_leaves(per)]
        res["summed"] = [np.asarray(x)
                         for x in jax.tree_util.tree_leaves(summed)]
        res["new_res"] = [np.asarray(x)
                          for x in jax.tree_util.tree_leaves(new_r)]
    results[(arch_id, compress)] = res
with open(out, "wb") as f:
    pickle.dump(results, f)
'''

_RANK = r'''
import pickle, sys, warnings
warnings.filterwarnings("ignore", category=FutureWarning)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, inp, ref_out, out = int(sys.argv[1]), \
    int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from repro_torch import configs, interop
from repro_torch.optim.optimizer import compressed_psum
from repro_torch.train.ddp import build_ddp_step
with open(inp, "rb") as f:
    data = pickle.load(f)
with open(ref_out, "rb") as f:
    ref = pickle.load(f)
results = {}
for (arch_id, compress), case in data["cases"].items():
    arch = data["port_archs"][arch_id]
    state = interop.train_state_from_arrays(arch, case["state"],
                                            device="cpu")
    fn = build_ddp_step(arch, compress=compress)
    metrics = []
    for batch in case["batches"]:
        state, m = fn(state, {k: torch.from_numpy(np.array(v))
                              for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    res = {"metrics": metrics, "state": interop.train_state_to_arrays(state)}
    if compress:
        r = ref[(arch_id, compress)]
        grads = [torch.from_numpy(np.array(g[rank])) for g in r["per_grads"]]
        summed, new_res = compressed_psum(
            grads, [torch.zeros_like(g) for g in grads])
        res["summed"] = [s.numpy() for s in summed]
        res["new_res"] = [x.numpy() for x in new_res]
    results[(arch_id, compress)] = res
with open(out, "wb") as f:
    pickle.dump(results, f)
dist.destroy_process_group()
'''


def _inputs():
    archs, port_archs, cases = {}, {}, {}
    import dataclasses

    from repro_torch import configs
    for arch_id, dims in ARCHS.items():
        ref_arch = ref_configs.reduced_config(arch_id)
        arch = configs.reduced_config(arch_id)
        ref_arch = dataclasses.replace(ref_arch, cells=(
            ref_configs.ShapeCell("ddp_train", "train", dims),))
        arch = dataclasses.replace(arch, cells=(
            configs.ShapeCell("ddp_train", "train", dims),))
        archs[arch_id], port_archs[arch_id] = ref_arch, arch
        params = ref_step.concrete_train_state(
            ref_arch, jax.random.PRNGKey(31))["params"]
        state = jax.tree_util.tree_map(np.asarray, ref_init_ddp(params))
        batches = [jax.tree_util.tree_map(np.asarray, ref_data.make_batch(
            ref_arch, "ddp_train", jax.random.PRNGKey(40 + i)))
            for i in range(STEPS)]
        for compress in (True, False):
            cases[(arch_id, compress)] = {"state": state,
                                          "batches": batches}
    return {"archs": archs, "port_archs": port_archs, "cases": cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    done = run_all({"jax": [sys.executable, "-c", _JAX, str(tmp / "in.pkl"),
                            str(tmp / "ref.pkl")]}, env, tmp, 300)
    rc, _, err = done["jax"]
    assert rc == 0, err[-4000:]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    cmds = {f"r{r}": [sys.executable, "-c", _RANK, str(r), str(WORLD),
                      str(tmp / "store"), str(tmp / "in.pkl"),
                      str(tmp / "ref.pkl"), str(tmp / f"r{r}.pkl")]
            for r in range(WORLD)}
    done = run_all(cmds, env, tmp, 300)
    for name, (rc, _, err) in done.items():
        assert rc == 0, f"{name} exited {rc}:\n{err[-4000:]}"
    out = {}
    for name in ("ref", *cmds):
        with open(tmp / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    return out


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _one_step_apart(got, want, what):
    """A residual within one quantization step (``2 max|want|``: the
    residual is at most half a step), under 1% of it a step apart."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    step = 2 * np.abs(want).max(initial=0.0)
    d = np.abs(got - want)
    assert d.max(initial=0.0) <= 1.01 * step, what
    assert (d > step / 4).mean() < 0.01, what


def _leaves(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch_id,compress", CASES,
                         ids=[f"{a}-{'int8' if c else 'f32'}"
                              for a, c in CASES])
def test_ddp_steps_equal_reference(runs, arch_id, compress):
    ref = runs["ref"][(arch_id, compress)]
    moments = 2 / 127 if compress else 1e-5
    for r in range(WORLD):
        got = runs[f"r{r}"][(arch_id, compress)]
        for step, (m, w) in enumerate(zip(got["metrics"], ref["metrics"])):
            _close(m["loss"], w["loss"], 1e-5, f"rank {r} step {step} loss")
            _close(m["lr"], w["lr"], 1e-6, "lr")
            _close(m["grad_norm"], w["grad_norm"], moments, "grad_norm")
        want = dict(_leaves(ref["state"]))
        have = _leaves(got["state"])
        assert [k for k, _ in have] == list(want)
        for k, a in have:
            if k.startswith("['residual']"):
                # each rank keeps its own residual; the reference's
                # replicated out_spec reads device 0's
                if r == 0:
                    _one_step_apart(a, want[k], f"rank {r} {k}")
                continue
            tol = 1e-5 if k.startswith("['params']") else moments
            _close(a, want[k], tol, f"rank {r} {k}")
        # parameters and moments stay replicated, bit for bit
        first = dict(_leaves(runs["r0"][(arch_id, compress)]["state"]))
        for k, a in have:
            if not k.startswith("['residual']"):
                np.testing.assert_array_equal(a, first[k])


@pytest.mark.parametrize("arch_id", sorted(ARCHS))
def test_compressed_all_reduce_is_bit_equal_given_the_same_gradients(
        runs, arch_id):
    ref = runs["ref"][(arch_id, True)]
    for r in range(WORLD):
        got = runs[f"r{r}"][(arch_id, True)]
        assert len(got["summed"]) == len(ref["summed"])
        for a, b in zip(got["summed"], ref["summed"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["new_res"], ref["new_res"]):
            np.testing.assert_array_equal(a, b[r])
