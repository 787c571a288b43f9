"""The port's training layer against the JAX package's ``train/step.py``.

From the same numpy inputs and the reference's own parameters carried in
(``interop.train_state_from_arrays``): the abstract state of all ten
full-size architectures against ``jax.eval_shape``'s; one train step of
all ten reduced architectures (loss, ``grad_norm``, ``lr``, parameters,
moments) within ``1e-5`` of each leaf's largest magnitude, five steps
within ``1e-4``; microbatched steps against the reference's scan; a bf16
LM's float32 accumulation against the reference's carry; the serve steps;
``input_specs``/``resolve_for_mesh`` for every registered cell; and
``tests/test_models_smoke.py``'s assertions on the port's own steps.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.data import synthetic as ref_data  # noqa: E402
from repro.optim import optimizer as ref_opt  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.data.synthetic import make_batch, statics_for  # noqa: E402
from repro_torch.optim.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCH_IDS = configs.ARCH_IDS
OPT_KW = {}      # the reference's defaults: lr 3e-4 after 100 warmup steps


def _train_cell(arch):
    return next(c for c in arch.cells if c.kind == "train")


def _ref_leaves(tree):
    """[(path tuple, leaf)] in jax order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in path), leaf))
    return out


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


def _close(got, want, rtol, what=""):
    """|got - want| within ``rtol`` of want's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _as_float(tree):
    """Port arrays (bf16 as uint16 bits) -> float arrays."""
    def f(a):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).float().numpy()
        return a.astype(np.float64) if a.dtype.kind == "f" else a
    return jax.tree_util.tree_map(f, tree)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _pair(arch_id, seed=0, cell=None):
    """(port arch, reference arch, train cell name, d_in, reference state,
    port state carrying it)."""
    arch = configs.reduced_config(arch_id)
    ref_arch = ref_configs.reduced_config(arch_id)
    cell = arch.cell(cell) if cell else _train_cell(arch)
    d_in = cell.dims.get("d_feat")
    ref_state = ref_step.concrete_train_state(
        ref_arch, jax.random.PRNGKey(seed), d_in=d_in)
    arrays = jax.tree_util.tree_map(np.asarray, ref_state)
    state = interop.train_state_from_arrays(arch, arrays, d_in,
                                            device="cpu")
    return arch, ref_arch, cell.name, d_in, ref_state, state


def _assert_state_close(state, ref_state, rtol):
    got = _as_float(interop.train_state_to_arrays(state))
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  ref_state)
    jax.tree_util.tree_map_with_path(
        lambda p, a, b: _close(a, b, rtol, jax.tree_util.keystr(p)),
        got, want)


# ----------------------------------------------------------- abstract state
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_abstract_state_matches_eval_shape(arch_id):
    arch, ref_arch = configs.get_config(arch_id), \
        ref_configs.get_config(arch_id)
    d_in = _train_cell(arch).dims.get("d_feat")
    state = tstep.abstract_train_state(arch, d_in)
    want = _ref_leaves(ref_step.abstract_train_state(ref_arch, d_in))
    got = tstep.state_leaves(state, meta=True)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, get), (_, w) in zip(got, want):
        t = get()
        assert t.device.type == "meta", path
        assert (tuple(t.shape), _dtype_name(t)) == \
            (tuple(w.shape), _dtype_name(w)), path
    assert all(p.device.type == "meta"
               for p in state["params"].parameters())
    mu = [get() for p, get in got if p[:2] == ("opt", "mu")]
    assert mu and all(t.dtype == torch.float32 for t in mu)
    assert [get().dtype for p, get in got if p == ("opt", "step")] == \
        [torch.int32]


# ---------------------------------------------------------------- the step
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_train_steps_equal_reference(arch_id):
    arch, ref_arch, cell, d_in, ref_state, state = _pair(arch_id)
    statics = statics_for(arch, cell)
    assert statics == ref_data.statics_for(ref_arch, cell)
    ref_fn = jax.jit(ref_step.build_train_step(
        ref_arch, ref_opt.AdamWConfig(**OPT_KW), statics=statics))
    fn = tstep.build_train_step(arch, AdamWConfig(**OPT_KW),
                                statics=statics)
    for i in range(5):
        batch = ref_data.make_batch(ref_arch, cell, jax.random.PRNGKey(i))
        ref_state, ref_m = ref_fn(ref_state, batch)
        state, m = fn(state, _to_torch(batch))
        rtol = 1e-5 if i == 0 else 1e-4
        for k in ("loss", "grad_norm", "lr"):
            assert m[k].dtype == torch.float32 and m[k].dim() == 0
            _close(m[k].item(), float(ref_m[k]), rtol, k)
        if i == 0:
            _assert_state_close(state, ref_state, 1e-5)
    _assert_state_close(state, ref_state, 1e-4)
    assert state["opt"].param_groups[0]["step"] == int(
        ref_state["opt"]["step"]) == 5


MB_ARCHS = {"smollm-360m": "mb_train", "autoint": "smoke_train"}


def _mb_arch(arch, ref_arch, cell):
    """An LM cell of batch 4, so 2 and 4 microbatches split it."""
    if cell != "mb_train":
        return arch, ref_arch
    dims = {"seq": 32, "batch": 4}
    return (dataclasses.replace(arch, cells=(configs.ShapeCell(
                cell, "train", dims),)),
            dataclasses.replace(ref_arch, cells=(ref_configs.ShapeCell(
                cell, "train", dims),)))


@pytest.mark.parametrize("microbatches", [2, 4])
@pytest.mark.parametrize("arch_id", sorted(MB_ARCHS))
def test_microbatched_step_equals_reference_scan(arch_id, microbatches):
    arch, ref_arch, _, _, ref_state, state = _pair(arch_id, seed=3)
    cell = MB_ARCHS[arch_id]
    arch, ref_arch = _mb_arch(arch, ref_arch, cell)
    batch = ref_data.make_batch(ref_arch, cell, jax.random.PRNGKey(4))
    ref_state, ref_m = jax.jit(ref_step.build_train_step(
        ref_arch, ref_opt.AdamWConfig(**OPT_KW),
        microbatches=microbatches))(ref_state, batch)
    state, m = tstep.build_train_step(
        arch, AdamWConfig(**OPT_KW), microbatches=microbatches)(
            state, _to_torch(batch))
    for k in ("loss", "grad_norm", "lr"):
        _close(m[k].item(), float(ref_m[k]), 1e-5, k)
    _assert_state_close(state, ref_state, 1e-5)


def test_gnn_batches_do_not_split_into_microbatches_in_either_package():
    """Both packages split every batch array's leading dim, so a GNN
    batch's ``(2, E)`` edge list splits into one-row halves that no GNN
    layer takes: the reference's scan and the port's loop refuse alike."""
    arch, ref_arch, cell, d_in, ref_state, state = _pair(
        "graphsage-reddit", cell="smoke_molecule")
    statics = statics_for(arch, cell)
    batch = ref_data.make_batch(ref_arch, cell, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="unpack"):
        ref_step.build_train_step(ref_arch, statics=statics,
                                  microbatches=2)(ref_state, batch)
    with pytest.raises(ValueError, match="unpack"):
        tstep.build_train_step(arch, statics=statics, microbatches=2)(
            state, _to_torch(batch))


def test_bf16_lm_accumulates_in_float32_like_the_reference_carry():
    """A bf16 LM's two microbatch gradients (bf16, one a parameter) go
    into float32 buffers, not a bf16 ``.grad``: the port's mean equals
    its own bf16 gradients summed in float32 exactly, and the reference's
    float32 carry within ``3e-2`` of each leaf's largest magnitude: each
    microbatch's gradient is a bf16 backward through the whole model,
    which the two packages round at different points (0.4-2.1% apart
    here, the embedding's the most: both add a repeated token's rows into
    a bf16 gradient, each in its own order)."""
    arch = configs.reduced_config("smollm-360m")
    ref_arch = ref_configs.reduced_config("smollm-360m")
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, param_dtype=torch.bfloat16))
    ref_arch = dataclasses.replace(ref_arch, model=dataclasses.replace(
        ref_arch.model, param_dtype=jnp.bfloat16))
    arch, ref_arch = _mb_arch(arch, ref_arch, "mb_train")
    ref_state = ref_step.concrete_train_state(ref_arch,
                                              jax.random.PRNGKey(5))
    state = interop.train_state_from_arrays(
        arch, jax.tree_util.tree_map(np.asarray, ref_state), device="cpu")
    assert state["params"].embed.dtype == torch.bfloat16
    batch = ref_data.make_batch(ref_arch, "mb_train", jax.random.PRNGKey(6))

    loss_fn = ref_step.loss_fn_for(ref_arch)
    carry = None
    for i in range(2):
        mb = jax.tree_util.tree_map(lambda x: x[2 * i:2 * i + 2], batch)
        _, g = jax.value_and_grad(loss_fn)(ref_state["params"], mb)
        carry = g if carry is None else jax.tree_util.tree_map(
            lambda a, b: a.astype(jnp.float32) + b, carry, g)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a) / 2, carry)

    model, opt = state["params"], state["opt"]
    params = opt.params()
    loss, grads = tstep.accumulate_grads(tstep.loss_fn_for(arch), model,
                                         params, _to_torch(batch), {}, 2)
    assert all(g.dtype == torch.float32 for g in grads)
    per_mb = [tstep.grads_of(tstep.loss_fn_for(arch), model, params,
                             {k: v[2 * i:2 * i + 2]
                              for k, v in _to_torch(batch).items()})[1]
              for i in range(2)]
    assert all(g.dtype == torch.bfloat16 for g in per_mb[0])
    for g, a, b in zip(grads, *per_mb):
        assert torch.equal(g, (a.float() + b.float()) / 2)
    # the port's gradients in the reference's layout (layers stacked)
    holder = {"params": model, "opt": opt, "residual": dict(zip(
        opt.param_groups[0]["param_names"], grads))}
    got = tstep.state_tree(holder)["residual"]
    jax.tree_util.tree_map_with_path(
        lambda p, a, b: _close(a.float().numpy(), b, 3e-2,
                               jax.tree_util.keystr(p)), got, want)


# --------------------------------------------------------------- serving
SERVE_CASES = {
    "graphsage-reddit/smoke_full": ("graphsage-reddit", "smoke_full", "train"),
    "nequip/smoke_molecule": ("nequip", "smoke_molecule", "train"),
    "pna/smoke_molecule": ("pna", "smoke_molecule", "train"),
    "smollm-360m/prefill": ("smollm-360m", "smoke_prefill", "prefill"),
    "gemma3-1b/decode": ("gemma3-1b", "smoke_decode", "decode"),
    "deepseek-moe-16b/decode": ("deepseek-moe-16b", "smoke_decode",
                                "decode"),
    "autoint/forward": ("autoint", "smoke_train", "serve"),
    "autoint/retrieval": ("autoint", "smoke_retrieval", "retrieval"),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_step_equals_reference(case):
    arch_id, cell, kind = SERVE_CASES[case]
    arch, ref_arch = configs.reduced_config(arch_id), \
        ref_configs.reduced_config(arch_id)
    d_in = arch.cell(cell).dims.get("d_feat")
    ref_state = ref_step.concrete_train_state(ref_arch,
                                              jax.random.PRNGKey(7), d_in)
    state = interop.train_state_from_arrays(
        arch, jax.tree_util.tree_map(np.asarray, ref_state), d_in,
        device="cpu")
    statics = statics_for(arch, cell)
    batch = ref_data.make_batch(ref_arch, cell, jax.random.PRNGKey(8))
    want = ref_step.build_serve_step(ref_arch, kind, statics=statics)(
        ref_state["params"], batch)
    if kind == "decode":
        tb = {"token": torch.from_numpy(np.array(batch["token"])),
              "cache": interop.decode_cache_from_arrays(
                  jax.tree_util.tree_map(np.asarray, batch["cache"]),
                  device="cpu")}
    else:
        tb = _to_torch(batch)
    got = tstep.build_serve_step(arch, kind, statics=statics)(
        state["params"], tb)
    if kind == "decode":
        (got, cache), (want, ref_cache) = got, want
        assert int(cache["len"]) == int(ref_cache["len"]) == \
            arch.cell(cell).dims["seq"] // 2 + 1
        for k in ("k", "v"):
            _close(cache[k].float().numpy(),
                   np.asarray(ref_cache[k], np.float32), 1e-2, k)
    assert not got.requires_grad
    _close(got.float().numpy(), np.asarray(want, np.float32), 1e-5, case)


# ----------------------------------------------------------- input specs
CELLS = [(a, c.name) for a in ARCH_IDS
         for c in configs.get_config(a).cells] + \
    [(a, c.name) for a in ARCH_IDS for c in configs.reduced_config(a).cells]
MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}


def _ref_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch_id,cell", CELLS,
                         ids=[f"{a}/{c}" for a, c in CELLS])
def test_input_specs_equal_reference(arch_id, cell):
    full = cell in {c.name for c in configs.get_config(arch_id).cells}
    arch = (configs.get_config if full else configs.reduced_config)(arch_id)
    ref_arch = (ref_configs.get_config if full
                else ref_configs.reduced_config)(arch_id)
    batch, specs, statics = shapes.input_specs(arch, cell)
    ref_batch, ref_specs, ref_statics = ref_shapes.input_specs(ref_arch,
                                                               cell)
    assert statics == ref_statics
    got = _ref_leaves(batch)
    want = _ref_leaves(ref_batch)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, t), (_, w) in zip(got, want):
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype_name(t)) == \
            (tuple(w.shape), _dtype_name(w)), p
    assert _spec_tuples(specs) == _spec_tuples(ref_specs)
    for sizes in MESHES.values():
        assert _spec_tuples(shapes.resolve_for_mesh(specs, sizes)) == \
            _spec_tuples(ref_shapes.resolve_for_mesh(ref_specs,
                                                     _ref_mesh(sizes)))
    if arch.family == "lm":
        c, rc = arch.cell(cell), ref_arch.cell(cell)
        assert _spec_tuples(shapes.decode_hint_specs(arch, c)) == \
            _spec_tuples(ref_shapes.decode_hint_specs(ref_arch, rc))


def test_configs_export_input_specs_as_the_reference_does():
    assert configs.input_specs is shapes.input_specs
    assert configs.resolve_for_mesh is shapes.resolve_for_mesh
    assert {"input_specs", "resolve_for_mesh"} <= set(configs.__all__)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_make_batch_follows_input_specs(arch_id):
    """Every reduced cell's batch has its specs' shapes and dtypes; a GNN
    batch equals the reference's drawn from the same numpy seed."""
    arch = configs.reduced_config(arch_id)
    ref_arch = ref_configs.reduced_config(arch_id)
    for c in arch.cells:
        key = jax.random.PRNGKey(11)
        batch = make_batch(arch, c.name, int(jax.random.randint(
            key, (), 0, 1 << 30)), device="cpu")
        specs, _, _ = shapes.input_specs(arch, c.name)
        assert [(p, tuple(t.shape), t.dtype) for p, t in _ref_leaves(batch)] \
            == [(p, tuple(t.shape), t.dtype) for p, t in _ref_leaves(specs)]
        if arch.family == "gnn":
            ref = ref_data.make_batch(ref_arch, c.name, key)
            assert sorted(batch) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(batch[k].numpy(),
                                              np.asarray(ref[k]))
        if c.kind == "decode":
            assert int(batch["cache"]["len"]) == c.dims["seq"] // 2


# ------------------------------------------ test_models_smoke's assertions
SMOKE = [(a, c.name) for a in ARCH_IDS
         for c in configs.reduced_config(a).cells if c.kind == "train"]


@pytest.mark.parametrize("arch_id,cell", SMOKE,
                         ids=[f"{a}/{c}" for a, c in SMOKE])
def test_port_train_step_smoke(arch_id, cell):
    arch = configs.reduced_config(arch_id)
    d_in = arch.cell(cell).dims.get("d_feat")
    state = tstep.concrete_train_state(arch, 0, d_in, device="cpu")
    before = [p.detach().clone() for p in state["params"].parameters()]
    step = tstep.build_train_step(arch, AdamWConfig(warmup_steps=1,
                                                    total_steps=10),
                                  statics=statics_for(arch, cell))
    state, metrics = step(state, make_batch(arch, cell, 0, device="cpu"))
    assert np.isfinite(float(metrics["loss"])), metrics
    assert np.isfinite(float(metrics["grad_norm"]))
    moved = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(before, state["params"].parameters()))
    assert moved > 0.0


@pytest.mark.parametrize("arch_id", [a for a in ARCH_IDS
                                     if configs.get_config(a).family
                                     == "lm"])
def test_port_prefill_and_decode_smoke(arch_id):
    arch = configs.reduced_config(arch_id)
    state = tstep.concrete_train_state(arch, 1, device="cpu")
    logits = tstep.build_serve_step(arch, "prefill")(
        state["params"], make_batch(arch, "smoke_prefill", 1, device="cpu"))
    assert logits.shape == (1, 48, arch.model.vocab_size)
    assert torch.isfinite(logits).all()
    batch = make_batch(arch, "smoke_decode", 1, device="cpu")
    before = int(batch["cache"]["len"])
    logits, cache = tstep.build_serve_step(arch, "decode")(state["params"],
                                                           batch)
    assert logits.shape == (2, 1, arch.model.vocab_size)
    assert int(cache["len"]) == before + 1
    assert torch.isfinite(logits).all()


def test_port_retrieval_smoke():
    arch = configs.reduced_config("autoint")
    state = tstep.concrete_train_state(arch, 2, device="cpu")
    scores = tstep.build_serve_step(arch, "retrieval")(
        state["params"], make_batch(arch, "smoke_retrieval", 2,
                                    device="cpu"))
    assert scores.shape == (2, 128)
    assert torch.isfinite(scores).all()
