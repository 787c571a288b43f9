"""The port's GNN models against the JAX package's ``models/gnn.py`` and
``models/equivariant.py``, on the CPU.

Every model is built from the reference's own ``init_gnn`` /
``init_nequip`` parameters (``repro_torch.interop``), and both packages
run the same numpy inputs: the segment ops; the forward of GraphSAGE, PNA
and GatedGCN (also with ``edge_attr`` as wide as the input and narrower,
which the reference pads) on ``smoke_full`` and the pooled
``smoke_molecule``, ``rtol 1e-5``/``atol 1e-6``; ``gnn_loss`` (masked
node cross entropy, pooled regression) and every gradient against
``jax.grad``, ``rtol 1e-4``/``atol 1e-6`` of each leaf's largest
magnitude (at a segment of zero variance the reference's ``segment_std``
scales f32 rounding of the messages by ``0.5 / sqrt(eps)`` = 158, so a
small element of a gradient may take an error of a larger one); NequIP's
energies (``rtol
1e-5``) and forces against ``-jax.grad`` (``rtol 1e-4``), and the
invariances and PNA checks of ``tests/test_models_gnn.py`` re-run on the
port; and ``gnn_batch`` against ``make_batch`` array for array.
"""

import copy
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs  # noqa: E402
from repro.configs.shapes import input_specs  # noqa: E402
from repro.data.synthetic import make_batch  # noqa: E402
from repro.models import equivariant as ref_eq  # noqa: E402
from repro.models import gnn as ref_gnn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.synthetic import gnn_batch  # noqa: E402
from repro_torch.interop import (gnn_from_params, nequip_from_params,  # noqa: E402
                                 params_to_arrays)
from repro_torch.models import equivariant as eq  # noqa: E402
from repro_torch.models import gnn  # noqa: E402


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(arch_id, cell, seed=7, full=False):
    """(reference batch with statics, port batch) of one cell from the
    seed the reference draws from ``PRNGKey(seed)``."""
    ref_arch = (ref_configs.get_config if full
                else ref_configs.reduced_config)(arch_id)
    arch = (configs.get_config if full else configs.reduced_config)(arch_id)
    key = jax.random.PRNGKey(seed)
    ref = make_batch(ref_arch, cell, key)
    ref.update(input_specs(ref_arch, cell)[2])
    drawn = int(jax.random.randint(key, (), 0, 1 << 30))
    return ref, gnn_batch(arch, cell, drawn, device="cpu")


def _close_to_largest(got, want, rtol=1e-4, atol=1e-6):
    """Every element within ``atol + rtol * max|want|``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max(initial=0.0)
    assert err <= atol + rtol * np.abs(want).max(initial=0.0), err


def _grads(model):
    """The port's gradients in the reference's pytree layout (a missing
    gradient is the zeros JAX gives)."""
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad if q.grad is not None else torch.zeros_like(q)
    return params_to_arrays(g)


# ------------------------------------------------------------ segment ops
SEGMENT_CASES = {
    "mean_std": (np.array([[1.0, 2.0], [3.0, -1.0], [5.0, 0.5],
                           [2.0, 2.0]], np.float32), [0, 0, 1, 0], 2),
    "empty_segments": (np.array([[2.0, -3.0]], np.float32), [1], 3),
    "ties": (np.array([[1.0], [1.0], [4.0], [4.0], [0.0]], np.float32),
             [0, 0, 1, 1, 1], 3),
    "random": (np.random.default_rng(3).normal(size=(50, 4))
               .astype(np.float32),
               np.random.default_rng(4).integers(0, 12, 50), 12),
}


def _ref_segments(data, seg, n):
    mx = jax.ops.segment_max(data, seg, num_segments=n)
    mn = -jax.ops.segment_max(-data, seg, num_segments=n)
    return {"mean": ref_gnn.segment_mean(data, seg, n),
            "std": ref_gnn.segment_std(data, seg, n),
            "max": jnp.where(jnp.isfinite(mx), mx, 0.0),
            "min": jnp.where(jnp.isfinite(mn), mn, 0.0),
            "sum": jax.ops.segment_sum(data, seg, num_segments=n)}


def _port_segments(data, seg, n):
    return {"mean": gnn.segment_mean(data, seg, n),
            "std": gnn.segment_std(data, seg, n),
            "max": gnn.segment_max(data, seg, n),
            "min": gnn.segment_min(data, seg, n),
            "sum": gnn.segment_sum(data, seg, n)}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_ops_equal_reference(case):
    data, seg, n = SEGMENT_CASES[case]
    seg = np.asarray(seg, np.int32)
    want = _ref_segments(jnp.asarray(data), jnp.asarray(seg), n)
    got = _port_segments(torch.as_tensor(data), torch.as_tensor(seg), n)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_op_gradients_equal_reference(case):
    """Tied rows share a max's gradient and empty segments take none, as
    in JAX."""
    data, seg, n = SEGMENT_CASES[case]
    seg = np.asarray(seg, np.int32)
    w = np.random.default_rng(1).normal(size=(n,) + data.shape[1:]) \
        .astype(np.float32)
    for k in ("mean", "std", "max", "min"):
        want = jax.jit(jax.grad(lambda d: jnp.sum(_ref_segments(
            d, jnp.asarray(seg), n)[k] * w)))(jnp.asarray(data))
        x = torch.as_tensor(data).requires_grad_(True)
        (torch.as_tensor(w) * _port_segments(
            x, torch.as_tensor(seg), n)[k]).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_empty_segment_is_zero():
    data = torch.tensor([[2.0]])
    seg = torch.tensor([1])
    for op in (gnn.segment_mean, gnn.segment_max, gnn.segment_min):
        out = op(data, seg, 3)
        assert out[0].item() == 0.0 and out[2].item() == 0.0
        assert out[1].item() == 2.0


# --------------------------------------------------------------- GNN models
# (arch id, edge_attr width relative to d_in: None = no edge_attr)
MODELS = {"graphsage": ("graphsage-reddit", None),
          "pna": ("pna", None),
          "gatedgcn": ("gatedgcn", None),
          "gatedgcn_edge_attr": ("gatedgcn", 0),
          "gatedgcn_edge_attr_narrow": ("gatedgcn", -3)}
CELLS = ["smoke_full", "smoke_molecule"]


@functools.cache
def _init_gnn(ref_cfg, d_in):
    return jax.jit(ref_gnn.init_gnn, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, d_in)


def _model_case(name, cell, *, labels_mask=True):
    arch_id, ea_delta = MODELS[name]
    ref_b, b = _batches(arch_id, cell)
    d_in = b["x"].shape[1]
    if ea_delta is not None:
        e = b["edge_index"].shape[1]
        ea = np.random.default_rng(5).normal(size=(e, d_in + ea_delta)) \
            .astype(np.float32)
        ref_b["edge_attr"], b["edge_attr"] = jnp.asarray(ea), \
            torch.as_tensor(ea)
    if not labels_mask:
        ref_b.pop("label_mask", None)
        b.pop("label_mask", None)
    ref_cfg = ref_configs.reduced_config(arch_id).model
    params = _init_gnn(ref_cfg, d_in)
    model = gnn_from_params(configs.reduced_config(arch_id).model,
                            _numpy(params), d_in, device="cpu")
    return ref_cfg, params, ref_b, model, b


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_gnn_forward_equals_reference(name, cell):
    ref_cfg, params, ref_b, model, b = _model_case(name, cell)
    want = np.asarray(jax.jit(
        lambda p: ref_gnn.gnn_forward(p, ref_cfg, ref_b))(params))
    with torch.no_grad():
        got = gnn.gnn_forward(model, b).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell,masked", [("smoke_full", True),
                                         ("smoke_full", False),
                                         ("smoke_molecule", False)])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_gnn_loss_and_gradients_equal_reference(name, cell, masked):
    ref_cfg, params, ref_b, model, b = _model_case(name, cell,
                                                   labels_mask=masked)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: ref_gnn.gnn_loss(p, ref_cfg, ref_b)))(params)
    got = gnn.gnn_loss(model, b)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4, atol=1e-6)
    jax.tree_util.tree_map(_close_to_largest, _grads(model), _numpy(grads))


def test_params_round_trip_through_the_port():
    cfg = ref_configs.reduced_config("gatedgcn").model
    params = _numpy(ref_gnn.init_gnn(jax.random.PRNGKey(2), cfg, 9))
    model = gnn_from_params(configs.reduced_config("gatedgcn").model,
                            params, 9, device="cpu")
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           params_to_arrays(model), params)
    with pytest.raises(ValueError, match="parameter trees differ"):
        gnn_from_params(configs.reduced_config("pna").model, params, 9,
                        device="cpu")


@pytest.mark.parametrize("kind", ["graphsage-reddit", "pna", "gatedgcn"])
def test_build_gnn_keeps_the_reference_layout_and_scales(kind):
    cfg = configs.get_config(kind).model
    model = gnn.build_gnn(cfg, 602, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    ref_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: ref_gnn.init_gnn(jax.random.PRNGKey(0),
                                     ref_configs.get_config(kind).model,
                                     602)))
    got = jax.tree_util.tree_map(lambda a: a.shape, params_to_arrays(model))
    assert got == ref_shapes
    w = model.embed.w.detach()
    assert abs(w.std().item() * 602 ** 0.5 - 1.0) < 0.05
    assert not model.embed.b.detach().any()
    same = gnn.build_gnn(cfg, 602, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(same.embed.w, model.embed.w)


# ------------------------------------------------------------------- NequIP
def _nequip(cell, full=False):
    ref_b, b = _batches("nequip", cell, full=full)
    ref_cfg = (ref_configs.get_config if full
               else ref_configs.reduced_config)("nequip").model
    params = jax.jit(ref_eq.init_nequip, static_argnums=(1,))(
        jax.random.PRNGKey(0), ref_cfg)
    model = nequip_from_params(
        (configs.get_config if full else configs.reduced_config)(
            "nequip").model, _numpy(params), device="cpu")
    return ref_cfg, params, ref_b, model, b


@pytest.mark.parametrize("cell", CELLS)
def test_nequip_energy_and_forces_equal_reference(cell):
    ref_cfg, params, ref_b, model, b = _nequip(cell)
    def energy(pos):
        return ref_eq.nequip_forward(params, ref_cfg,
                                     dict(ref_b, positions=pos))
    want = np.asarray(jax.jit(energy)(ref_b["positions"]))
    forces_want = -np.asarray(jax.jit(jax.grad(
        lambda pos: energy(pos).sum()))(ref_b["positions"]))
    energy, forces = eq.nequip_forces(model, b)
    np.testing.assert_allclose(energy.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(forces.numpy(), forces_want, rtol=1e-4,
                               atol=1e-6)


def test_nequip_registered_width_equals_reference():
    """The registered 5 layers x 32 channels on the molecule cell."""
    ref_cfg, params, ref_b, model, b = _nequip("molecule", full=True)
    want = np.asarray(jax.jit(
        lambda p: ref_eq.nequip_forward(p, ref_cfg, ref_b))(params))
    with torch.no_grad():
        got = eq.nequip_forward(model, b).numpy()
    assert got.shape == (128,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_nequip_loss_gradients_equal_reference(cell):
    ref_cfg, params, ref_b, model, b = _nequip(cell)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: ref_eq.nequip_energy_loss(p, ref_cfg, ref_b)))(params)
    got = eq.nequip_energy_loss(model, b)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4, atol=1e-6)
    jax.tree_util.tree_map(_close_to_largest, _grads(model), _numpy(grads))


def _random_molecule(seed, n=12, e=40):
    rng = np.random.default_rng(seed)
    return {"positions": torch.as_tensor(
                rng.normal(size=(n, 3)).astype(np.float32) * 2.0),
            "species": torch.as_tensor(rng.integers(0, 8, n)),
            "edge_index": torch.as_tensor(rng.integers(0, n, (2, e))),
            "node_graph": torch.zeros(n, dtype=torch.int64),
            "labels": torch.zeros(1), "n_graphs": 1}


def _rotation(seed):
    """Random proper rotation via QR."""
    a = torch.as_tensor(np.random.default_rng(seed).normal(size=(3, 3)),
                        dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    q[:, 0] *= torch.sign(torch.linalg.det(q))       # force det=+1
    return q


@pytest.fixture(scope="module")
def nequip_small():
    return eq.build_nequip(configs.reduced_config("nequip").model,
                           device="cpu")


@pytest.mark.parametrize("rot_seed", [10, 11, 12])
def test_nequip_energy_rotation_invariant(nequip_small, rot_seed):
    batch = _random_molecule(1)
    with torch.no_grad():
        e0 = eq.nequip_forward(nequip_small, batch)
        rot = _rotation(rot_seed)
        e1 = eq.nequip_forward(nequip_small, dict(
            batch, positions=batch["positions"] @ rot.T))
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=2e-4, atol=2e-5)


def test_nequip_energy_translation_invariant(nequip_small):
    batch = _random_molecule(2)
    with torch.no_grad():
        e0 = eq.nequip_forward(nequip_small, batch)
        e1 = eq.nequip_forward(nequip_small, dict(
            batch, positions=batch["positions"] + 7.5))
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=1e-4, atol=1e-5)


def test_nequip_energy_depends_on_geometry(nequip_small):
    batch = _random_molecule(3)
    with torch.no_grad():
        e0 = eq.nequip_forward(nequip_small, batch)
        e1 = eq.nequip_forward(nequip_small, dict(
            batch, positions=batch["positions"] * 1.5))    # stretch
    assert abs(e0[0].item() - e1[0].item()) > 1e-6


def test_nequip_forces_via_grad_finite(nequip_small):
    batch = _random_molecule(4)
    _, forces = eq.nequip_forces(nequip_small, batch)
    assert forces.shape == batch["positions"].shape
    assert torch.isfinite(forces).all()


def test_sym_traceless_equals_reference():
    m = np.random.default_rng(0).normal(size=(5, 3, 3)).astype(np.float32)
    st = eq.sym_traceless(torch.as_tensor(m))
    np.testing.assert_allclose(st.numpy(), np.asarray(
        ref_eq.sym_traceless(jnp.asarray(m))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st.numpy(), st.transpose(-1, -2).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        st.diagonal(dim1=-2, dim2=-1).sum(-1).numpy(), 0.0, atol=1e-6)


def test_bessel_basis_equals_reference():
    r = np.array([0.0, 0.5, 2.0, 4.9, 5.0, 6.0], np.float32)
    b = eq.bessel_basis(torch.as_tensor(r), 8, 5.0)
    assert b.shape == (6, 8)
    np.testing.assert_allclose(b.numpy(), np.asarray(
        ref_eq.bessel_basis(jnp.asarray(r), 8, 5.0)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b[4].numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(b[5].numpy(), 0.0, atol=1e-3)


def test_tensor_product_paths_equal_reference():
    rng = np.random.default_rng(8)
    e, c = 6, 3
    x0 = rng.normal(size=(e, c)).astype(np.float32)
    x1 = rng.normal(size=(e, c, 3)).astype(np.float32)
    x2 = np.asarray(ref_eq.sym_traceless(jnp.asarray(
        rng.normal(size=(e, c, 3, 3)).astype(np.float32))))
    rh = rng.normal(size=(e, 3)).astype(np.float32)
    rh /= np.linalg.norm(rh, axis=-1, keepdims=True)
    y2 = np.asarray(ref_eq.sym_traceless(jnp.asarray(
        rh[:, :, None] * rh[:, None, :])))
    w = rng.normal(size=(e, len(eq.PATHS), c)).astype(np.float32)
    want = jax.jit(lambda x0, x1, x2, rh, y2, w: ref_eq._tp_accumulate(
        {0: x0, 1: x1, 2: x2}, {1: rh, 2: y2}, w, c))(x0, x1, x2, rh, y2, w)
    got = eq._tp_accumulate(*(torch.tensor(a) for a in
                              (x0, x1, x2, rh, y2, w)))
    assert eq.PATHS == ref_eq._PATHS
    for lo in range(3):
        np.testing.assert_allclose(got[lo].numpy(), np.asarray(want[lo]),
                                   rtol=1e-5, atol=1e-6, err_msg=str(lo))


# ---------------------------------------------------------------- PNA checks
def _pna(d_in):
    return gnn.build_gnn(configs.reduced_config("pna").model, d_in,
                         device="cpu")


def test_pna_uses_all_aggregators():
    """Each aggregator's columns of ``post`` move the output: with any one
    zeroed the logits change."""
    model = _pna(4)
    rng = np.random.default_rng(0)
    n = 10
    batch = {"x": torch.as_tensor(rng.normal(size=(n, 4)).astype(np.float32)),
             "edge_index": torch.as_tensor(rng.integers(0, n, (2, 30))),
             "node_graph": torch.zeros(n, dtype=torch.int64),
             "pool": False, "n_graphs": 1}
    with torch.no_grad():
        out = gnn.gnn_forward(model, batch)
        assert out.shape == (n, 5) and torch.isfinite(out).all()
        d = model.cfg.d_hidden
        for agg in range(4):                     # mean, max, min, std
            cut = copy.deepcopy(model)
            for layer in cut.layers:
                rows = slice(d * (1 + 3 * agg), d * (4 + 3 * agg))
                layer.post.w[rows] = 0.0
            assert not torch.allclose(gnn.gnn_forward(cut, batch), out)


def test_pna_isolated_nodes_finite():
    model = _pna(4)
    batch = {"x": torch.ones(6, 4),
             "edge_index": torch.tensor([[0, 1], [1, 0]]),  # 2..5 isolated
             "node_graph": torch.zeros(6, dtype=torch.int64),
             "pool": False, "n_graphs": 1}
    out = gnn.gnn_forward(model, batch)
    assert torch.isfinite(out).all()
    gnn.gnn_loss(model, dict(batch, labels=torch.zeros(6, dtype=torch.int64))
                 ).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


# ------------------------------------------------------------ gnn_batch
@pytest.mark.parametrize("arch_id", ["graphsage-reddit", "pna", "gatedgcn",
                                     "nequip"])
@pytest.mark.parametrize("cell,full", [("smoke_full", False),
                                       ("smoke_molecule", False),
                                       ("full_graph_sm", True),
                                       ("molecule", True)])
def test_gnn_batch_equals_make_batch(arch_id, cell, full):
    ref, got = _batches(arch_id, cell, seed=11, full=full)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k in ("pool", "n_graphs"):
            assert got[k] == v
        else:
            assert got[k].dtype == torch.from_numpy(np.array(v)).dtype, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=k)


def test_gnn_batch_pads_big_cells_as_the_reference():
    """minibatch_lg's counts are 512-multiples already; ogb_products pads
    2,449,029 nodes to 2,449,408 and 61,859,140 edges to 61,859,328 (the
    reference's input specs, checked without drawing the batch)."""
    ref_arch = ref_configs.get_config("graphsage-reddit")
    specs, _, _ = input_specs(ref_arch, "ogb_products")
    assert specs["x"].shape == (2_449_408, 100)
    assert specs["edge_index"].shape == (2, 61_859_328)
    from repro_torch.configs.shapes import pad_to
    assert (pad_to(2_449_029), pad_to(61_859_140)) == (2_449_408, 61_859_328)
