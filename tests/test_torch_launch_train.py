"""The port's training launcher, ``repro_torch.launch.train``, on the CPU.

A run stopped after the checkpoint of step 6 and resumed to step 10
equals a straight 10-step run bit for bit; its checkpoint restores in the
JAX package's ``restore_checkpoint`` against the reference's
``concrete_train_state`` tree; the launcher prints the reference's lines;
and the GNN and recsys families train through it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train.step import state_leaves  # noqa: E402

ARGS = ["--arch", "smollm-360m", "--reduced", "--steps", "10",
        "--ckpt-every", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    return launch.main(ARGS + ["--ckpt", str(tmp_path_factory.mktemp("s"))])


def _stop_at(monkeypatch, step):
    real = launch.make_batch

    def batches(arch, cell, seed, **kw):
        if seed == launch.batch_seed(step):
            raise KeyboardInterrupt("stopped")
        return real(arch, cell, seed, **kw)
    monkeypatch.setattr(launch, "make_batch", batches)


def test_resumed_run_equals_straight_run(straight, tmp_path, monkeypatch,
                                         capsys):
    ckpt = str(tmp_path)
    _stop_at(monkeypatch, 6)
    with pytest.raises(KeyboardInterrupt):
        launch.main(ARGS + ["--ckpt", ckpt])
    monkeypatch.undo()
    state, metrics = launch.main(ARGS + ["--ckpt", ckpt])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=smollm-360m cell=smoke_train params=")
    assert lines[0].endswith("M devices=1")
    assert "resumed from step 6" in lines
    assert any(ln.startswith("step     9 loss=") and " gnorm=" in ln
               for ln in lines)
    assert lines[-1] == "done"
    assert float(metrics["loss"]) == float(straight[1]["loss"])
    got, want = state_leaves(state), state_leaves(straight[0])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        a, b = a(), b()
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_checkpoint_restores_in_the_reference(straight, tmp_path):
    state = straight[0]
    launch.save_checkpoint(str(tmp_path), 10, state, extras={"step": 10})
    ref_arch = ref_configs.reduced_config("smollm-360m")
    like = ref_step.concrete_train_state(ref_arch, jax.random.PRNGKey(0))
    tree, extras = ref_ckpt.restore_checkpoint(str(tmp_path), like)
    assert extras == {"step": 10}
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(like)
    mine = interop.train_state_to_arrays(state)
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(tree["opt"]["step"]) == 10


@pytest.mark.parametrize("arch,cell", [("graphsage-reddit", "smoke_full"),
                                       ("nequip", "smoke_molecule"),
                                       ("autoint", None)])
def test_other_families_train_through_the_launcher(arch, cell, capsys):
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--device", "cpu"]
    state, metrics = launch.main(argv + (["--cell", cell] if cell else []))
    assert np.isfinite(float(metrics["loss"]))
    assert state["opt"].param_groups[0]["step"] == 3
    assert capsys.readouterr().out.splitlines()[-1] == "done"
