"""The port's checkpoints against the JAX package's ``train/checkpoint.py``.

``tests/test_optim.py::TestCheckpoint``'s four cases on the port; a bf16
reduced LM train state saved by either package and restored by the other
bit for bit, every leaf and dtype, its next step held to the other
package's; and, with ``_MAX_SHARD_BYTES`` patched small in both modules,
the same shard index, file count and leaf bytes.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs  # noqa: E402
from repro.data import synthetic as ref_data  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.checkpoint import (available_steps,  # noqa: E402
                                          latest_step, restore_checkpoint,
                                          save_checkpoint)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(10, dtype=torch.float32),
                "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16),
                      "d": torch.zeros((), dtype=torch.int32)},
                "lst": [torch.tensor([1.0]), torch.tensor([2.0])]}
        save_checkpoint(str(tmp_path), 7, tree, extras={"note": "hi"})
        out, extras = restore_checkpoint(str(tmp_path), tree)
        assert extras["note"] == "hi"
        assert isinstance(out["lst"], list)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(out)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)

    def test_latest_pointer_and_retention(self, tmp_path):
        tree = {"x": torch.ones((4,))}
        for step in (1, 2, 3, 4, 5):
            save_checkpoint(str(tmp_path), step, tree, keep=3)
        assert latest_step(str(tmp_path)) == 5
        assert available_steps(str(tmp_path)) == [3, 4, 5]

    def test_corrupt_tmp_ignored(self, tmp_path):
        tree = {"x": torch.ones((4,))}
        save_checkpoint(str(tmp_path), 1, tree)
        # simulate a crashed mid-write checkpoint
        os.makedirs(tmp_path / "step_000000009.tmp")
        assert latest_step(str(tmp_path)) == 1
        out, _ = restore_checkpoint(str(tmp_path), tree)
        assert out is not None

    def test_structure_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": torch.ones((4,))})
        with pytest.raises(ValueError, match="structure changed"):
            restore_checkpoint(str(tmp_path), {"x": torch.ones((4,)),
                                               "y": torch.ones((2,))})


def test_train_state_of_another_model_raises(tmp_path):
    arch = configs.reduced_config("smollm-360m")
    state = tstep.concrete_train_state(arch, 0, device="cpu")
    save_checkpoint(str(tmp_path), 1, state, extras={"step": 1})
    wider = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, d_ff=128))
    with pytest.raises(ValueError, match="w_down"):
        restore_checkpoint(str(tmp_path), tstep.concrete_train_state(
            wider, 0, device="cpu"))
    with pytest.raises(ValueError, match="structure changed"):
        restore_checkpoint(str(tmp_path), tstep.concrete_train_state(
            configs.reduced_config("autoint"), 0, device="cpu"))


# ------------------------------------------- across packages, bf16 LM state
def _bf16_lm():
    arch = configs.reduced_config("smollm-360m")
    ref_arch = ref_configs.reduced_config("smollm-360m")
    return (dataclasses.replace(arch, model=dataclasses.replace(
                arch.model, param_dtype=torch.bfloat16)),
            dataclasses.replace(ref_arch, model=dataclasses.replace(
                ref_arch.model, param_dtype=jnp.bfloat16)))


def _bits(tree):
    """Leaves as (dtype name, raw bytes): bf16 of either package alike."""
    def one(a):
        a = np.asarray(a)
        name = "bfloat16" if a.dtype in (np.uint16,) or \
            a.dtype.name == "bfloat16" else a.dtype.name
        return name, a.shape, a.tobytes()
    return [one(a) for a in jax.tree_util.tree_leaves(tree)]


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _float(tree):
    def f(a):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).float().numpy()
        return np.asarray(a, np.float64)
    return [f(a) for a in jax.tree_util.tree_leaves(tree)]


def _next_steps_agree(state, ref_state, arch, ref_arch):
    """One more step in each package from the same state and batch: the
    bf16 parameters within ``1e-2`` of each leaf's largest magnitude, the
    f32 moments within ``3e-2`` (a bf16 backward in each package, see
    ``tests/test_torch_train.py``), the loss within ``1e-2``."""
    batch = ref_data.make_batch(ref_arch, "smoke_train",
                                jax.random.PRNGKey(21))
    ref_state, ref_m = ref_step.build_train_step(ref_arch)(ref_state, batch)
    state, m = tstep.build_train_step(arch)(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    _close(m["loss"].item(), float(ref_m["loss"]), 1e-2)
    got = interop.train_state_to_arrays(state)
    for path, a, b in zip(
            [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(got)[0]],
            _float(got), _float(jax.tree_util.tree_map(np.asarray,
                                                       ref_state))):
        _close(a, b, 3e-2 if "opt" in path else 1e-2)


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """A bf16 reduced LM state one reference step in (moments non-zero,
    step 1), and the port's state one port step in from the same start."""
    arch, ref_arch = _bf16_lm()
    ref_state = ref_step.concrete_train_state(ref_arch,
                                              jax.random.PRNGKey(20))
    start = jax.tree_util.tree_map(np.asarray, ref_state)
    batch = ref_data.make_batch(ref_arch, "smoke_train",
                                jax.random.PRNGKey(22))
    ref_state, _ = ref_step.build_train_step(ref_arch)(ref_state, batch)
    state = interop.train_state_from_arrays(arch, start, device="cpu")
    state, _ = tstep.build_train_step(arch)(
        state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return arch, ref_arch, ref_state, state


def test_port_restores_the_reference_checkpoint(stepped, tmp_path):
    arch, ref_arch, ref_state, _ = stepped
    ref_ckpt.save_checkpoint(str(tmp_path), 1, ref_state,
                             extras={"step": 1})
    state = tstep.concrete_train_state(arch, 5, device="cpu")
    out, extras = restore_checkpoint(str(tmp_path), state)
    assert out is state and extras == {"step": 1}
    assert state["params"].layers[0].attn.wq.dtype == torch.bfloat16
    assert state["opt"].param_groups[0]["step"] == 1
    assert _bits(interop.train_state_to_arrays(state)) == _bits(
        jax.tree_util.tree_map(np.asarray, ref_state))
    _next_steps_agree(state, ref_state, arch, ref_arch)


def test_reference_restores_the_port_checkpoint(stepped, tmp_path):
    arch, ref_arch, _, state = stepped
    save_checkpoint(str(tmp_path), 1, state, extras={"step": 1})
    like = ref_step.concrete_train_state(ref_arch, jax.random.PRNGKey(9))
    ref_state, extras = ref_ckpt.restore_checkpoint(str(tmp_path), like)
    assert extras == {"step": 1}
    assert jax.tree_util.tree_structure(ref_state) == \
        jax.tree_util.tree_structure(like)
    assert ref_state["params"]["embed"].dtype == jnp.bfloat16
    assert _bits(jax.tree_util.tree_map(np.asarray, ref_state)) == _bits(
        interop.train_state_to_arrays(state))
    ref_state = jax.tree_util.tree_map(jnp.asarray, ref_state)
    _next_steps_agree(state, ref_state, arch, ref_arch)


def test_both_packages_shard_alike(stepped, tmp_path, monkeypatch):
    """With ``_MAX_SHARD_BYTES`` at 16 KiB in both modules, the same
    state gives the same ``meta.json`` (but ``treedef``) and the same
    bytes in each shard file."""
    arch, _, ref_state, _ = stepped
    state = interop.train_state_from_arrays(
        arch, jax.tree_util.tree_map(np.asarray, ref_state), device="cpu")
    monkeypatch.setattr(ckpt, "_MAX_SHARD_BYTES", 16 << 10)
    monkeypatch.setattr(ref_ckpt, "_MAX_SHARD_BYTES", 16 << 10)
    mine = ckpt.save_checkpoint(str(tmp_path / "port"), 3, state,
                                extras={"step": 3})
    theirs = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref_state,
                                      extras={"step": 3})
    metas = []
    for d in (mine, theirs):
        with open(os.path.join(d, "meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0]["treedef"] is None and metas[1]["treedef"]
    for m in metas:
        del m["treedef"]
    assert metas[0] == metas[1]
    assert len(set(metas[0]["shard_of_leaf"])) > 3
    files = [sorted(os.listdir(d)) for d in (mine, theirs)]
    assert files[0] == files[1]
    for name in files[0]:
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(mine, name)) as a, \
                np.load(os.path.join(theirs, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
