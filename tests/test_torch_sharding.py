"""The port's sharding rules against the JAX package's
``train/sharding.py``.

Every parameter, moment (ZeRO-1) and batch spec of all ten full-size
architectures equals the reference's on the ``(16, 16)`` and
``(2, 16, 16)`` production meshes; under 4 gloo ranks on a ``(data 2,
model 2)`` ``DeviceMesh``, each rank's ``shard_train_state`` shard of a
reduced LM's parameters and moments equals the slice the reference's
``NamedSharding`` gives the device at the same mesh position (one JAX
process on 4 forced host devices); and ``spec_to_placements`` follows the
mesh order or raises.
"""

import os
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.data import synthetic as ref_data  # noqa: E402
from repro.train import sharding as ref_shd  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch.ranks import run_all  # noqa: E402
from repro_torch.train import sharding as shd  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ref_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _tuples(tree):
    """A spec tree of either package as nested dicts/lists of tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch_id", configs.ARCH_IDS)
def test_param_and_moment_specs_equal_reference(arch_id, mesh):
    sizes = MESHES[mesh]
    arch, ref_arch = configs.get_config(arch_id), \
        ref_configs.get_config(arch_id)
    cell = next(c for c in arch.cells if c.kind == "train")
    d_in = cell.dims.get("d_feat")
    state = tstep.abstract_train_state(arch, d_in)
    params = tstep.params_tree(state["params"], meta=True)
    specs = tstep.param_specs_for(arch, params, sizes)
    opt = shd.opt_state_specs(specs, params, sizes)

    ref_params = ref_step.abstract_train_state(ref_arch, d_in)["params"]
    rmesh = _ref_mesh(sizes)
    ref_specs = ref_step.param_specs_for(ref_arch, ref_params, rmesh)
    ref_opt = ref_shd.opt_state_specs(ref_specs, ref_params, rmesh)
    assert _tuples(specs) == _tuples(ref_specs)
    for k in ("mu", "nu"):
        assert _tuples(opt[k]) == _tuples(ref_opt[k])
    assert tuple(opt["step"]) == tuple(ref_opt["step"]) == ()
    assert _tuples(shd.opt_state_specs(specs)["mu"]) == _tuples(specs)
    # the module itself gives the same specs as its layout tree
    assert _tuples(tstep.param_specs_for(arch, state["params"], sizes)) == \
        _tuples(specs)

    batch, _, _ = shapes.input_specs(arch, cell.name)
    ref_batch, _, _ = ref_shapes.input_specs(ref_arch, cell.name)
    assert _tuples(shd.batch_specs(batch, sizes)) == \
        _tuples(ref_shd.batch_specs(ref_batch, rmesh))


def test_spec_to_placements_follows_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    sizes = MESHES["2x16x16"]
    got = shd.spec_to_placements(sizes, shapes.PartitionSpec(
        ("pod", "data"), "model"), (64, 32))
    assert got == (Shard(0), Shard(0), Shard(1))
    assert shd.spec_to_placements(sizes, shapes.PartitionSpec(None)) == \
        (Replicate(),) * 3
    assert shd.spec_to_placements(MESHES["16x16"], shapes.PartitionSpec(
        None, ("data", "model"))) == (Shard(1), Shard(1))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.spec_to_placements(sizes, shapes.PartitionSpec(
            ("data", "pod"), None))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.spec_to_placements(sizes, shapes.PartitionSpec(
            None, ("model", "data")))
    with pytest.raises(ValueError, match="twice"):
        shd.spec_to_placements(sizes, shapes.PartitionSpec("data", "data"))
    with pytest.raises(ValueError, match="not on the mesh"):
        shd.spec_to_placements(MESHES["16x16"],
                               shapes.PartitionSpec("pod"))
    with pytest.raises(ValueError, match="does not divide"):
        shd.spec_to_placements(sizes, shapes.PartitionSpec(
            ("pod", "data")), (48,))


# ---------------------------------------------- shards on a (2, 2) mesh
_JAX = r'''
import pickle, sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
inp, out = sys.argv[1], sys.argv[2]
with open(inp, "rb") as f:
    data = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"))
res = {}
for path, (shape, spec) in data.items():
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    res[path] = {(i, j): [(s.start, s.stop) for s in
                          (idx[mesh.devices[i, j]] + (slice(None),) *
                           len(shape))[:len(shape)]]
                 for i in range(2) for j in range(2)}
with open(out, "wb") as f:
    pickle.dump(res, f)
'''

_RANK = r'''
import pickle, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
from repro_torch import configs, interop
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import sharding as shd
from repro_torch.train import step as tstep
with open(inp, "rb") as f:
    arrays = pickle.load(f)
arch = configs.reduced_config("smollm-360m")
state = interop.train_state_from_arrays(arch, arrays, device="cpu")
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
params = tstep.params_tree(state["params"], meta=True)
specs = tstep.param_specs_for(arch, params, mesh)
tree = shd.shard_train_state(state, mesh, {
    "params": specs, "opt": shd.opt_state_specs(specs, params, mesh)})
local = {}
def walk(path, t):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(path + (k,), v)
    elif isinstance(t, list):
        for i, v in enumerate(t):
            walk(path + (i,), v)
    elif isinstance(t, int):
        local[path] = t
    else:
        local[path] = (t.to_local().numpy(), tuple(t.placements))
walk((), tree)
with open(out, "wb") as f:
    pickle.dump({"coord": tuple(mesh.get_coordinate()), "local": local}, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard")
    ref_arch = ref_configs.reduced_config("smollm-360m")
    ref_state = ref_step.concrete_train_state(ref_arch,
                                              jax.random.PRNGKey(3))
    batch = ref_data.make_batch(ref_arch, "smoke_train",
                                jax.random.PRNGKey(4))
    ref_state, _ = ref_step.build_train_step(ref_arch)(ref_state, batch)
    arrays = jax.tree_util.tree_map(np.asarray, ref_state)
    rmesh = _ref_mesh({"data": 2, "model": 2})
    specs = ref_step.param_specs_for(ref_arch, ref_state["params"], rmesh)
    opt = ref_shd.opt_state_specs(specs, ref_state["params"], rmesh)
    full = {"params": (arrays["params"], specs),
            "opt/mu": (arrays["opt"]["mu"], opt["mu"]),
            "opt/nu": (arrays["opt"]["nu"], opt["nu"])}
    leaves, want = {}, {}
    for prefix, (tree, spec) in full.items():
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_spec = jax.tree_util.tree_leaves(
            spec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for (path, a), sp in zip(flat, flat_spec):
            key = tuple(prefix.split("/")) + tuple(
                getattr(k, "key", getattr(k, "idx", None)) for k in path)
            leaves[key] = a
            want[key] = (a.shape, tuple(sp))
    with open(tmp / "shapes.pkl", "wb") as f:
        pickle.dump(want, f)
    with open(tmp / "state.pkl", "wb") as f:
        pickle.dump(arrays, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = {"jax": [sys.executable, "-c", _JAX, str(tmp / "shapes.pkl"),
                    str(tmp / "ref.pkl")]}
    env_t = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    done = run_all(cmds, env, tmp, 240)
    assert done["jax"][0] == 0, done["jax"][2][-4000:]
    ranks = {f"r{r}": [sys.executable, "-c", _RANK, str(r),
                       str(tmp / "store"), str(tmp / "state.pkl"),
                       str(tmp / f"r{r}.pkl")] for r in range(4)}
    done = run_all(ranks, env_t, tmp, 240)
    for name, (rc, _, err) in done.items():
        assert rc == 0, f"{name} exited {rc}:\n{err[-4000:]}"
    out = {}
    for name in ("ref", *ranks):
        with open(tmp / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    return leaves, want, out


@pytest.mark.parametrize("rank", range(4))
def test_local_shards_equal_the_reference_named_sharding(shards, rank):
    from torch.distributed.tensor import Shard
    leaves, want, out = shards
    got = out[f"r{rank}"]
    coord = got["coord"]
    assert coord == (rank // 2, rank % 2)
    n_sharded = 0
    for key, full in leaves.items():
        local, placements = got["local"][key]
        slices = out["ref"][key][coord]
        expect = full[tuple(slice(a, b) for a, b in slices)]
        np.testing.assert_array_equal(local, expect)
        n_sharded += any(isinstance(p, Shard) for p in placements)
    assert got["local"][("opt", "step")] == 1
    assert n_sharded > len(leaves) // 2
