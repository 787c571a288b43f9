"""The port's ``examples/gnn_motif_features_torch.py`` against the JAX
package's ``examples/gnn_motif_features.py`` training loop, on the CPU.

Both packages count the motif features of the example's planted graph
(which must be equal: integer tables, float64 sums) and train GraphSAGE
from the same carried ``init_gnn(PRNGKey(0))`` parameters with AdamW on
the same features: the per-step losses agree within ``rtol 1e-4`` over the
first 20 steps, the final losses after 150 within ``rtol 1e-3``, and the
motif run's held-out accuracy equals the reference's.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.api import motif_features as ref_motif_features  # noqa: E402
from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.graph import Graph as RefGraph  # noqa: E402
from repro.models.gnn import gnn_forward, gnn_loss, init_gnn  # noqa: E402
from repro.optim.optimizer import (AdamWConfig, adamw_update,  # noqa: E402
                                   init_adamw)
from repro_torch.api import motif_features  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.interop import gnn_from_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS = 150


def _example():
    spec = importlib.util.spec_from_file_location(
        "gnn_motif_features_torch",
        ROOT / "examples" / "gnn_motif_features_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    ex = _example()
    prob = ex.planted_graph()
    ref_g = RefGraph.from_edges(prob["g"].n, prob["edges"])
    ref_feats = ref_motif_features(ref_g, ex.TEMPLATES, n_iters=8, seed=1)
    feats = motif_features(prob["g"], ex.TEMPLATES, n_iters=8, seed=1,
                           device="cpu")
    cfg = ref_reduced_config("graphsage-reddit").model
    src, dst = ref_g.edges_by_dst
    out = {"features": (feats, np.asarray(ref_feats))}
    for key, x in (("random", prob["base_x"]),
                   ("motif", np.concatenate([prob["base_x"], feats], 1))):
        batch = {"x": jnp.asarray(x),
                 "edge_index": jnp.asarray(np.stack([src, dst])),
                 "labels": jnp.asarray(prob["labels"]),
                 "label_mask": jnp.asarray(prob["train_mask"]),
                 "node_graph": jnp.zeros((ref_g.n,), jnp.int32),
                 "pool": False, "n_graphs": 1}
        params = init_gnn(jax.random.PRNGKey(0), cfg, d_in=x.shape[1])
        model = gnn_from_params(reduced_config("graphsage-reddit").model,
                                jax.tree_util.tree_map(np.asarray, params),
                                x.shape[1], device="cpu")
        ocfg = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=200,
                           weight_decay=0.0)

        @jax.jit
        def step(params, opt):
            loss, grads = jax.value_and_grad(
                lambda p: gnn_loss(p, cfg, batch))(params)
            params, opt, _ = adamw_update(ocfg, params, grads, opt)
            return params, opt, loss

        opt, ref_losses = init_adamw(params), []
        for _ in range(STEPS):
            params, opt, loss = step(params, opt)
            ref_losses.append(float(loss))
        pred = np.asarray(jnp.argmax(gnn_forward(params, cfg, batch), -1))
        ev = prob["eval_nodes"]
        ref_acc = float((pred[ev] == prob["labels"][ev]).mean())
        losses, acc = ex.train(model, x, prob, steps=STEPS, device="cpu")
        out[key] = {"port": (losses, acc), "ref": (ref_losses, ref_acc)}
    return out


def test_motif_features_equal_reference(runs):
    got, want = runs["features"]
    assert got.shape == (320, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["random", "motif"])
def test_first_20_losses_agree(runs, key):
    np.testing.assert_allclose(runs[key]["port"][0][:20],
                               runs[key]["ref"][0][:20], rtol=1e-4)


@pytest.mark.parametrize("key", ["random", "motif"])
def test_final_losses_agree(runs, key):
    got, want = runs[key]["port"][0], runs[key]["ref"][0]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-3)


def test_motif_run_accuracy_equals_reference_and_gains(runs):
    assert runs["motif"]["port"][1] == runs["motif"]["ref"][1]
    assert runs["motif"]["port"][1] > runs["random"]["port"][1]


def test_example_main_runs_on_the_cpu(capsys, monkeypatch):
    ex = _example()
    out = ex.main(device="cpu", steps=5)
    text = capsys.readouterr().out
    assert "motif-feature gain on held-out anchors" in text
    assert out["features"].shape == (320, 3)
    assert len(out["motif"]["losses"]) == 5
    assert all(np.isfinite(out[k]["losses"]).all() for k in ("random",
                                                             "motif"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.main()
