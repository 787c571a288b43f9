"""Sharding rules: map param/batch trees to PartitionSpecs per family, and
the specs to DTensor placements.

A port of the JAX package's ``train/sharding.py``. Conventions:
  data axis  — batch / vertices / tokens / edges ("dp" + "pod" for multi-pod)
  model axis — heads / ffn / experts / vocab / color-combinations ("tp"/"ep")

Rules are path-keyed over the reference's parameter layout
(:func:`repro_torch.train.step.params_tree`: an LM's layers stacked along
a leading axis): the most specific suffix match wins, anything unmatched
is replicated. A mesh is a ``DeviceMesh`` with named dims or a mapping
``{axis name: size}`` in mesh order; the specs are
:class:`repro_torch.configs.shapes.PartitionSpec`.

A spec has one entry a tensor dim; DTensor takes one placement a mesh dim.
:func:`spec_to_placements` converts: a tensor dim split over the axes
``(a, b)`` becomes ``Shard(d)`` on mesh dims ``a`` and ``b``, which
DTensor splits in mesh order, so the tuple must follow the mesh's order
(JAX splits it major to minor in the tuple's order). The rules shard only
dims the axes divide; DTensor would pad an uneven split, JAX refuses one,
so the conversion asserts divisibility.
"""

from __future__ import annotations

import math

from repro_torch.configs.shapes import PartitionSpec as P, mesh_axis_sizes

__all__ = ["lm_param_specs", "gnn_param_specs", "recsys_param_specs",
           "batch_specs", "spec_to_placements", "shard_train_state",
           "opt_state_specs", "DATA_AXES"]

DATA_AXES = ("pod", "data")  # batch shards over both on a multi-pod mesh


def _data(mesh):
    names = mesh_axis_sizes(mesh)
    return tuple(a for a in DATA_AXES if a in names) or None


def lm_param_specs(params, mesh):
    """Megatron-style TP: attention heads and FFN width over `model`;
    experts over `model` (EP); embeddings vocab-sharded over `model`.

    Dims that don't divide the model-axis size fall back (heads -> head_dim
    -> replicated): e.g. smollm's 15 heads or gemma3's 4 heads can't split 16
    ways, but their 64/256-wide head_dim can.
    """
    dm = mesh_axis_sizes(mesh)["model"]

    def shardable(n: int) -> bool:
        return n % dm == 0

    def attn_spec(r: int, h: int, dh: int, trailing_d: bool):
        # layouts: (.., D, H, Dh) for wq/wk/wv; (.., H, Dh, D) for wo
        if trailing_d:
            if shardable(h):
                return P(*([None] * (r - 3) + ["model", None, None]))
            if shardable(dh):
                return P(*([None] * (r - 3) + [None, "model", None]))
            return P(*([None] * r))
        if shardable(h):
            return P(*([None] * (r - 2) + ["model", None]))
        if shardable(dh):
            return P(*([None] * (r - 1) + ["model"]))
        return P(*([None] * r))

    def rule(path: str, x):
        r = len(x.shape)
        if "q_norm" in path or "k_norm" in path:
            return P(*([None] * r))
        if "embed" in path and "species" not in path:  # (V, D)
            return P("model", None)
        if "lm_head" in path:                     # (D, V)
            return P(None, "model")
        if "wq" in path or "wk" in path or "wv" in path:
            return attn_spec(r, x.shape[-2], x.shape[-1], False)
        if "wo" in path:                          # (.., H, Dh, D)
            return attn_spec(r, x.shape[-3], x.shape[-2], True)
        if "moe" in path and "shared" not in path and \
                ("w_gate" in path or "w_up" in path or "w_down" in path):
            # (L, E, d, f) — experts over model
            return P(*([None] * (r - 3) + ["model", None, None]))
        if "router" in path:
            return P(*([None] * r))
        if "w_gate" in path or "w_up" in path:    # dense mlp (.., D, F)
            if shardable(x.shape[-1]):
                return P(*([None] * (r - 1) + ["model"]))
            return P(*([None] * r))
        if "w_down" in path:                      # (.., F, D)
            if shardable(x.shape[-2]):
                return P(*([None] * (r - 2) + ["model", None]))
            return P(*([None] * r))
        return P(*([None] * r))

    return _by_path(params, rule)


def gnn_param_specs(params, mesh):
    dm = mesh_axis_sizes(mesh)["model"]

    def rule(path: str, x):
        r = len(x.shape)
        if r == 2:
            if x.shape[-1] >= 64 and x.shape[-1] % dm == 0:
                return P(None, "model")           # wide layers over model
            if x.shape[0] >= 64 and x.shape[0] % dm == 0:
                return P("model", None)
        return P(*([None] * r))

    return _by_path(params, rule)


def recsys_param_specs(params, mesh):
    def rule(path: str, x):
        r = len(x.shape)
        if "tables" in path:                      # (F, V, D): vocab-sharded
            return P(None, "model", None)
        return P(*([None] * r))

    return _by_path(params, rule)


def batch_specs(batch, mesh, *, data_dims: dict | None = None):
    """Shard the leading dim of every batch array over the data axes,
    unless listed in data_dims with an explicit spec."""
    d = _data(mesh)

    def rule(path, x):
        if data_dims and path in data_dims:
            return data_dims[path]
        r = len(x.shape)
        if r == 0:
            return P()
        return P(*((d,) + (None,) * (r - 1)))

    return _by_path(batch, rule)


def opt_state_specs(param_specs, param_shapes=None, mesh=None):
    """ZeRO-1: optimizer moments additionally shard over the data axes.

    fp32 Adam moments are 4x the bf16 params; for each param the data axes
    go on the largest unsharded dim that they divide (reduce-scatter grads
    -> local moment update -> all-gather params).
    """
    if param_shapes is None or mesh is None:
        return {"mu": param_specs, "nu": param_specs, "step": P()}
    d = _data(mesh)
    sizes = mesh_axis_sizes(mesh)
    d_size = math.prod(sizes[ax] for ax in (d or ()))

    def zero1(spec, shape_leaf):
        shape = tuple(shape_leaf.shape)
        if d is None or not shape:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        cands = [i for i, e in enumerate(entries)
                 if e is None and shape[i] % d_size == 0 and shape[i] > 1]
        if not cands:
            return spec
        best = max(cands, key=lambda i: shape[i])
        entries[best] = d if len(d) > 1 else d[0]
        return P(*entries)

    moment_specs = _zip_specs(zero1, param_specs, param_shapes)
    return {"mu": moment_specs, "nu": moment_specs, "step": P()}


def spec_to_placements(mesh, spec, shape=None) -> tuple:
    """A spec -> DTensor placements, one a mesh dim: ``Shard(d)`` on every
    mesh dim named in tensor dim ``d``'s entry, ``Replicate()`` on the
    rest. Raises ``ValueError`` for an axis tuple out of mesh order, an
    axis the mesh lacks or names twice, and, given ``shape``, a dim its
    axes do not divide."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    placements = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in sizes]
        if missing:
            raise ValueError(f"spec {spec} names {missing}, not on the mesh "
                             f"{names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec} splits dim {dim} over {axes}, out of the "
                f"mesh's order {names}: DTensor would split it in mesh "
                f"order, JAX in the tuple's")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {names[i]} "
                                 f"twice")
            placements[i] = Shard(dim)
        parts = math.prod(sizes[a] for a in axes)
        if shape is not None and shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {axes} ({parts} ways)")
    return tuple(placements)


def shard_train_state(state: dict, mesh, specs: dict) -> dict:
    """Every parameter and moment of a train state as a DTensor on
    ``mesh`` (a ``DeviceMesh``) at ``specs`` = ``{"params": param specs,
    "opt": opt_state_specs(...)}``: the reference's pytree ``{"params",
    "opt": {"mu", "nu", "step"}}`` (an LM's layers stacked) of DTensors,
    each rank holding its shard; the step stays an int. The state itself
    is not changed."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.train.step import _nest, state_leaves
    flat_specs = dict(_spec_leaves(specs))
    out = {}
    for path, get in state_leaves(state):
        if path == ("opt", "step"):
            out[path] = int(get())
            continue
        if path not in flat_specs:
            raise ValueError(f"no spec for {'/'.join(map(str, path))}")
        leaf = get()
        placements = spec_to_placements(mesh, flat_specs[path], leaf.shape)
        out[path] = distribute_tensor(leaf.to(mesh.device_type), mesh,
                                      placements)
    return _nest(out)


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, P):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, prefix + (i,))


def _zip_specs(fn, specs, shapes):
    """``fn(spec, shape leaf)`` over a spec tree and a shape tree of the
    same structure."""
    if isinstance(specs, P):
        return fn(specs, shapes)
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, v, shapes[k]) for k, v in specs.items()}
    return type(specs)(_zip_specs(fn, s, x) for s, x in zip(specs, shapes))


def _by_path(tree, rule):
    def walk(path, t):
        if isinstance(t, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [walk(f"{path}/{i}", v) for i, v in enumerate(t)]
            return type(t)(out)
        return rule(path, t)

    return walk("", tree)

