"""Train/serve step builders for every architecture family.

A port of the JAX package's ``train/step.py``. A train state is a dict
with the reference's keys: ``{"params": the family's nn.Module, "opt":
its AdamW}`` (built from ``named_parameters()``, moments made at once, as
``init_adamw`` makes them), and ``"residual"`` (float32, one a parameter
name) for the DDP step. ``build_train_step(arch)`` returns
``step(state, batch) -> (state, metrics)``; the step updates the state in
place and returns the same dict, with ``metrics`` the reference's
``loss``, ``grad_norm`` and ``lr`` (0-d float32 tensors).

The reference's state is a pytree. :func:`state_tree` gives the port's
state in its layout (an LM's per-block parameters stacked along a leading
axis, as the reference scans them; ``self_`` named ``self``), and
:func:`state_leaves` its leaves in ``jax.tree_util`` order (dict keys
sorted, lists by index): the order a checkpoint writes them in.

:func:`abstract_train_state` builds the model and its moments on the
meta device, so nothing is allocated, where the reference takes
``jax.eval_shape``. ``build_train_step`` accumulates microbatch gradients
in a Python loop; the reference's ``unroll_microbatches`` (a Python loop
in place of its ``lax.scan``, so HLO cost analysis sees each microbatch)
has no counterpart.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import equivariant as eq_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizer import AdamW, AdamWConfig
from repro_torch.train import sharding as shd

__all__ = ["build_train_step", "build_serve_step", "abstract_train_state",
           "concrete_train_state", "loss_fn_for", "init_params_fn",
           "param_specs_for", "state_tree", "state_leaves", "params_tree",
           "load_state_leaves", "grads_of", "accumulate_grads",
           "tree_leaves", "state_specs", "distribute_state",
           "distribute_tree"]

_META = torch.device("meta")


# ------------------------------------------------------------------- losses
def loss_fn_for(arch: ArchConfig):
    """-> ``loss(model, batch)``, the family's scalar training loss."""
    m = arch.model
    if arch.family == "lm":
        def loss(model, batch):
            return tfm.lm_loss(model, batch["tokens"], batch["targets"])
    elif arch.family == "gnn" and m.kind == "nequip":
        loss = eq_mod.nequip_energy_loss
    elif arch.family == "gnn":
        loss = gnn_mod.gnn_loss
    elif arch.family == "recsys":
        loss = rec_mod.autoint_loss
    else:
        raise ValueError(arch.family)
    return loss


def init_params_fn(arch: ArchConfig, d_in: int | None = None):
    """-> ``init(generator, device)``, the family's module on ``device``
    (taken as given: ``"meta"`` builds it without drawing) from
    ``generator``. The GNNs draw on the generator's device (a CPU one
    gives the same model on every device); the LMs and AutoInt draw on
    ``device`` itself, from a generator that lives there."""
    m = arch.model
    if arch.family == "lm":
        return lambda gen, dev: tfm.LM(m, device=dev, generator=gen)
    if arch.family == "gnn" and m.kind == "nequip":
        return lambda gen, dev: eq_mod.NequIP(m, 16, device=dev,
                                              generator=gen)
    if arch.family == "gnn":
        return lambda gen, dev: gnn_mod.GNN(m, d_in, device=dev,
                                            generator=gen)
    if arch.family == "recsys":
        return lambda gen, dev: rec_mod.AutoInt(m, device=dev, generator=gen)
    raise ValueError(arch.family)


def param_specs_for(arch: ArchConfig, params, mesh):
    """The parameters' partition specs on ``mesh`` (a ``DeviceMesh`` or
    ``{axis: size}``); ``params`` is the reference-layout tree
    (:func:`params_tree`) or the module itself."""
    if isinstance(params, nn.Module):
        params = params_tree(params, meta=True)
    if arch.family == "lm":
        return shd.lm_param_specs(params, mesh)
    if arch.family == "recsys":
        return shd.recsys_param_specs(params, mesh)
    return shd.gnn_param_specs(params, mesh)


# -------------------------------------------------------------- train state
def _generator(arch: ArchConfig, seed: int, dev: torch.device):
    on = "cpu" if arch.family == "gnn" or dev.type == "meta" else dev
    return torch.Generator(device=on).manual_seed(int(seed))


def _state(model: nn.Module) -> dict:
    opt = AdamW(model.named_parameters(), AdamWConfig())
    opt.init_moments()
    return {"params": model, "opt": opt}


def abstract_train_state(arch: ArchConfig, d_in: int | None = None) -> dict:
    """The train state on the meta device: every parameter and moment a
    shape and a dtype, nothing allocated, no card needed (the dry run's
    state)."""
    return _state(init_params_fn(arch, d_in)(_generator(arch, 0, _META),
                                             _META))


def concrete_train_state(arch: ArchConfig, seed: int = 0,
                         d_in: int | None = None, *, device=None) -> dict:
    """The train state of ``arch`` on ``device`` (CUDA unless ``"cpu"``),
    its parameters drawn from ``seed``, its moments zero and its step 0."""
    dev = resolve_device(device)
    return _state(init_params_fn(arch, d_in)(_generator(arch, seed, dev),
                                             dev))


# ------------------------------------------------------ the reference layout
def _ref_path(name: str) -> tuple:
    return tuple(int(p) if p.isdigit() else ("self" if p == "self_" else p)
                 for p in name.split("."))


def _slots(model: nn.Module) -> dict:
    """reference leaf path -> [(parameter name, its index along the
    stacked axis, or None)]; an LM's ``layers.<i>.<rest>`` is row ``i`` of
    the reference's stacked ``layers/<rest>``."""
    stacked = isinstance(model, tfm.LM)
    out: dict = {}
    for name, _ in model.named_parameters():
        path = _ref_path(name)
        if stacked and path[0] == "layers":
            out.setdefault(("layers",) + path[2:], []).append((name,
                                                               path[1]))
        else:
            out[path] = [(name, None)]
    return out


def _leaf(slots, tensors: dict, meta: bool = False) -> torch.Tensor:
    (name, idx), *_ = slots
    if idx is None:
        t = tensors[name]
        return torch.empty_like(t, device=_META) if meta else t
    rows = [tensors[n] for n, _ in sorted(slots, key=lambda s: s[1])]
    if meta:
        t = rows[0]
        return torch.empty((len(rows),) + tuple(t.shape), dtype=t.dtype,
                           device=_META)
    return torch.stack(rows)


def _nest(flat: dict):
    """{path: leaf} -> nested dicts, a level whose keys are all ints a
    list."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def tree_leaves(tree, prefix=()) -> list:
    """[(path, leaf)] of nested dicts, lists and tuples in
    ``jax.tree_util`` order: dict keys sorted, lists by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def _with_empty(model: nn.Module, tree: dict) -> dict:
    """An LM's empty ``layers``/``dense_front`` as the reference holds
    them ({} and [])."""
    if isinstance(model, tfm.LM):
        tree.setdefault("layers", {})
        tree.setdefault("dense_front", [])
    return tree


def params_tree(model: nn.Module, *, meta: bool = False) -> dict:
    """The module's parameters in the reference's pytree layout (stacked
    LM layers are copies); ``meta=True`` gives meta tensors of the same
    shapes and dtypes, nothing copied."""
    named = {n: p.detach() for n, p in model.named_parameters()}
    flat = {path: _leaf(s, named, meta) for path, s in _slots(model).items()}
    return _with_empty(model, _nest(flat))


def _named_state(state: dict) -> dict:
    """prefix -> {parameter name: tensor} for params, mu, nu, residual."""
    model, opt = state["params"], state["opt"]
    by_param = dict(zip(opt.params(), opt.param_groups[0]["param_names"]))
    out = {("params",): {n: p.detach() for n, p in model.named_parameters()},
           ("opt", "mu"): {}, ("opt", "nu"): {}}
    for p, name in by_param.items():
        for k in ("mu", "nu"):
            out[("opt", k)][name] = opt.state[p][k]
    if "residual" in state:
        out[("residual",)] = state["residual"]
    return out


def state_leaves(state: dict, *, meta: bool = False) -> list:
    """[(reference path, leaf)] of a train state in ``jax.tree_util``
    order. A stacked LM leaf is built when it is reached (``meta=True``:
    a meta tensor), so a caller that takes one leaf at a time holds one
    stacked copy at a time; the AdamW step is a 0-d int32 tensor."""
    slots = _slots(state["params"])
    items = []
    for prefix, tensors in _named_state(state).items():
        for path, s in slots.items():
            items.append((prefix + path,
                          lambda s=s, t=tensors: _leaf(s, t, meta)))
    step = state["opt"].param_groups[0]["step"]
    items.append((("opt", "step"), lambda: torch.tensor(
        step, dtype=torch.int32, device=_META if meta else None)))
    items.sort(key=lambda kv: kv[0])
    return items


def state_tree(state: dict, *, meta: bool = False) -> dict:
    """The train state as the reference's pytree ``{"opt": {"mu", "nu",
    "step"}, "params"[, "residual"]}`` of tensors."""
    tree = _nest({path: get() for path, get in state_leaves(state,
                                                            meta=meta)})
    model = state["params"]
    for key in ("params", "residual"):
        if key in tree:
            _with_empty(model, tree[key])
    for k in ("mu", "nu"):
        _with_empty(model, tree["opt"][k])
    return tree


def load_state_leaves(state: dict, leaves: list) -> dict:
    """Write ``leaves`` (tensors in :func:`state_leaves` order, on any
    device) into ``state`` in place: parameters, moments, residuals and
    the step. Raises ``ValueError`` when the count or a shape differs."""
    want = state_leaves(state, meta=True)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} leaves for a state of "
                         f"{len(want)}: structure changed?")
    slots = _slots(state["params"])
    named = _named_state(state)
    with torch.no_grad():
        for (path, get), leaf in zip(want, leaves):
            expect = get()
            if (tuple(leaf.shape), leaf.dtype) != (tuple(expect.shape),
                                                   expect.dtype):
                raise ValueError(f"{'/'.join(map(str, path))}: "
                                 f"{leaf.dtype}{tuple(leaf.shape)}, the "
                                 f"state's {expect.dtype}"
                                 f"{tuple(expect.shape)}")
            if path == ("opt", "step"):
                for group in state["opt"].param_groups:
                    group["step"] = int(leaf)
                continue
            prefix = path[:2] if path[0] == "opt" else path[:1]
            for name, idx in slots[path[len(prefix):]]:
                dst = named[prefix][name]
                dst.copy_(leaf if idx is None else leaf[idx])
    return state


# ------------------------------------------------------ DTensor placements
def state_specs(arch: ArchConfig, state: dict, mesh) -> dict:
    """``{"params": param specs, "opt": ZeRO-1 moment specs}`` of a train
    state on ``mesh``, in the reference's layout (LM layers stacked)."""
    pspecs = param_specs_for(arch, state["params"], mesh)
    return {"params": pspecs,
            "opt": shd.opt_state_specs(
                pspecs, params_tree(state["params"], meta=True), mesh)}


def _local_shard(t: torch.Tensor, mesh, placements, device) -> torch.Tensor:
    """An empty tensor on ``device`` (a fake one under a fake mode) of the
    shape of rank ``mesh.get_coordinate()``'s shard of the meta tensor
    ``t`` at ``placements`` (dims split in mesh order, divisibility
    asserted by the specs)."""
    from torch.distributed.tensor import Shard
    if t.device.type != "meta":
        raise ValueError("only an abstract (meta) state or batch is "
                         "placed on a mesh here")
    shape = list(t.shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            shape[pl.dim] //= mesh.size(i)
    return torch.empty(shape, dtype=t.dtype, device=device)


def _dtensor(t: torch.Tensor, mesh, spec, device):
    """The meta tensor ``t`` as a DTensor at ``spec``, this rank's shard
    an empty tensor on ``device``; a split over a one-rank mesh dim is no
    split (DTensor would refuse to reshape such a dim). On a one-rank
    mesh every placement is whole: a plain tensor comes back, as a
    one-card run holds it."""
    from torch.distributed.tensor import DTensor, Replicate
    placements = tuple(
        Replicate() if mesh.size(i) == 1 else p
        for i, p in enumerate(shd.spec_to_placements(mesh, spec, t.shape)))
    local = _local_shard(t, mesh, placements, device)
    if mesh.size() == 1:
        return local
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())


def distribute_tree(tree, specs, mesh, device):
    """A tree of meta tensors (a batch of ``configs/shapes.input_specs``)
    as DTensors on ``mesh`` at ``specs``, each rank's shard an empty
    tensor on ``device``; on a one-rank mesh plain tensors. Non-tensor
    leaves pass through."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, mesh, device)
                          for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return _dtensor(tree, mesh, specs, device)
    return tree


def distribute_state(state: dict, mesh, specs: dict, device) -> dict:
    """The train state with every parameter and AdamW moment a DTensor on
    ``mesh`` (a ``DeviceMesh``) at ``specs`` (:func:`state_specs`), in
    place: each module parameter becomes a DTensor parameter, the
    optimizer is rebuilt over them with its config and step, and each
    moment is put at its ZeRO-1 spec. An LM layer's parameter takes its
    stacked spec without the stacked dim (:func:`_slots`). The state is
    :func:`abstract_train_state`'s (meta): each rank's shards are empty
    tensors on ``device`` (fake ones under a fake mode); on a one-rank
    mesh plain tensors. The scatters' sharding rules
    (:func:`repro_torch.train.op_sharding.install`) are registered with
    DTensor first. Returns ``state``."""
    from repro_torch.configs.shapes import PartitionSpec as P
    from repro_torch.train import op_sharding
    from repro_torch.train.sharding import _spec_leaves
    op_sharding.install()
    model, opt = state["params"], state["opt"]
    flat = dict(_spec_leaves(specs))
    by_name = {}
    for path, slots in _slots(model).items():
        for name, idx in slots:
            by_name[name] = (path, idx)

    def spec_of(prefix, name):
        path, idx = by_name[name]
        spec = flat[prefix + path]
        return spec if idx is None else P(*tuple(spec)[1:])

    moments = {name: opt.state[p] for p, name
               in zip(opt.params(), opt.param_groups[0]["param_names"])}
    step = opt.param_groups[0]["step"]
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(
            _dtensor(p, mesh, spec_of(("params",), name), device),
            requires_grad=p.requires_grad))
    new = AdamW(model.named_parameters(), opt.cfg)
    for group in new.param_groups:
        group["step"] = step
    for p, name in zip(new.params(), new.param_groups[0]["param_names"]):
        for k in ("mu", "nu"):
            new.state[p][k] = _dtensor(moments[name][k], mesh,
                                       spec_of(("opt", k), name), device)
    state["opt"] = new
    return state


# ---------------------------------------------------------------- the step
def _split(x, microbatches: int, i: int):
    """Microbatch ``i`` of ``microbatches``: rows ``[i * b, (i + 1) * b)``
    of the leading dim, ``b = len(x) // microbatches`` (the reference's
    reshape to ``(microbatches, b, ...)`` and its row ``i``). A DTensor's
    slice comes back on the batch's placements, each rank holding its
    share of the microbatch."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    size = x.shape[0] // microbatches
    part = x.narrow(0, i * size, size)
    placements = getattr(x, "placements", None)
    if placements is not None and part.placements != placements:
        part = part.redistribute(x.device_mesh, placements)
    return part


def grads_of(loss_fn, model: nn.Module, params: list, batch: dict):
    """-> (loss, gradients in ``params``' order); a parameter the loss
    does not reach gets zeros, as ``jax.grad`` gives it."""
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, grads)]


def accumulate_grads(loss_fn, model: nn.Module, params: list, batch: dict,
                     statics: dict, microbatches: int):
    """-> (the mean loss, the mean gradients) over ``microbatches``
    contiguous slices of every batch array's leading dim: each slice's
    gradients (in its parameter's dtype) are added into float32 buffers,
    not through ``.grad``, which torch keeps in a bf16 parameter's dtype,
    and the sums are divided at the end, as the reference's scan with its
    float32 carry does."""
    grads = [torch.zeros_like(p, dtype=torch.float32,
                              memory_format=torch.contiguous_format)
             for p in params]
    loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for i in range(microbatches):
        mb = {k: _split(v, microbatches, i) for k, v in batch.items()}
        mb_loss, g = grads_of(loss_fn, model, params, {**mb, **statics})
        for acc, gi in zip(grads, g):
            acc.add_(gi)
        del g
        loss = loss + mb_loss
    for acc in grads:
        acc.div_(microbatches)
    return loss / microbatches, grads


def build_train_step(arch: ArchConfig, opt_cfg: AdamWConfig | None = None,
                     statics: dict | None = None, microbatches: int = 1):
    """``statics`` (e.g. the GNN pool flag, ``n_graphs``) join every
    batch. ``microbatches`` > 1 accumulates gradients
    (:func:`accumulate_grads`), shrinking activation memory about
    ``microbatches``-fold; AdamW then takes the float32 means.
    """
    opt_cfg = opt_cfg or AdamWConfig()
    loss_fn = loss_fn_for(arch)
    statics = statics or {}

    def step(state, batch):
        model, opt = state["params"], state["opt"]
        params = opt.params()
        if microbatches <= 1:
            loss, grads = grads_of(loss_fn, model, params,
                                   {**batch, **statics})
        else:
            loss, grads = accumulate_grads(loss_fn, model, params, batch,
                                           statics, microbatches)
        opt.step(grads=grads, cfg=opt_cfg)
        metrics = {"grad_norm": opt.last_grad_norm,
                   "lr": opt.last_lr.to(loss.device), "loss": loss}
        return state, metrics

    return step


# ------------------------------------------------------------------ serving
def build_serve_step(arch: ArchConfig, cell_kind: str,
                     statics: dict | None = None,
                     shard_hints: dict | None = None):
    """-> ``serve(model, batch)`` of the family and cell kind, without
    autograd: the GNN forward (NequIP's energies), an LM prefill's logits
    or a decode step's ``(logits, cache)`` (the cache written in place),
    AutoInt's logits or retrieval scores."""
    m = arch.model
    statics = statics or {}
    if arch.family == "gnn":
        inner = (eq_mod.nequip_forward if m.kind == "nequip"
                 else gnn_mod.gnn_forward)

        def serve(model, batch):
            return inner(model, {**batch, **statics})
    elif arch.family == "lm":
        if cell_kind == "prefill":
            def serve(model, batch):
                return tfm.lm_prefill(model, batch["tokens"])
        else:  # decode
            def serve(model, batch):
                return tfm.lm_decode_step(model, batch["cache"],
                                          batch["token"],
                                          shard_hints=shard_hints)
    elif arch.family == "recsys":
        if cell_kind == "retrieval":
            def serve(model, batch):
                return rec_mod.retrieval_scores(model, batch,
                                                batch["candidates"],
                                                batch["retrieval_proj"])
        else:
            serve = rec_mod.autoint_forward
    else:
        raise ValueError(arch.family)
    return torch.no_grad()(serve)
