"""Per-family shape cells and input-spec builders.

A port of the JAX package's ``configs/shapes.py``. ``input_specs(arch,
cell)`` returns (the batch tree as meta tensors, its partition specs, the
statics): a meta tensor is the counterpart of ``jax.ShapeDtypeStruct``,
a shape and a dtype with nothing allocated. Node and candidate counts of
the big cells are padded to the next multiple of 512 (the real pipeline
pads identically: :func:`repro_torch.data.synthetic.gnn_batch`).

The specs are the port's :class:`PartitionSpec`: one entry a tensor dim,
each a mesh axis name, a tuple of names (the dim split over several mesh
axes, major to minor) or ``None`` (not split). DTensor placements are one
a *mesh* dim, so they cannot hold a per-tensor-dim spec; the conversion
is :func:`repro_torch.train.sharding.spec_to_placements`.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell

__all__ = ["lm_cells", "gnn_cells", "recsys_cells", "input_specs",
           "decode_hint_specs", "resolve_for_mesh", "pad_to",
           "PartitionSpec", "map_specs", "mesh_axis_sizes"]


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: a tuple of one entry a tensor dim, as
    ``jax.sharding.PartitionSpec`` holds them (a one-axis tuple entry
    becomes its axis, an empty one ``None``)."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec
DATA = ("pod", "data")   # flattened over both when present (mesh-dependent)
_META = torch.device("meta")


def map_specs(fn, tree):
    """``fn`` on every :class:`PartitionSpec` of a tree of dicts, lists
    and tuples, the structure kept."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return fn(tree)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``)
    or of a mapping of names to sizes, in mesh order."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dimensions have no names")
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def pad_to(n: int, mult: int = 512) -> int:
    return -(-n // mult) * mult


# ------------------------------------------------------------------- cells
def lm_cells() -> tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
        ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
        ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
        ShapeCell("long_500k", "decode", {"seq": 524288, "batch": 1}),
    )


def gnn_cells() -> tuple[ShapeCell, ...]:
    # minibatch_lg: 1024 seeds, fanout 15-10 => 169,984 nodes / 168,960 edges
    return (
        ShapeCell("full_graph_sm", "train",
                  {"n": 2708, "e": 10556, "d_feat": 1433}),
        ShapeCell("minibatch_lg", "train",
                  {"n": 169_984, "e": 168_960, "d_feat": 602,
                   "seeds": 1024}),
        ShapeCell("ogb_products", "train",
                  {"n": 2_449_029, "e": 61_859_140, "d_feat": 100}),
        ShapeCell("molecule", "train",
                  {"n": 30, "e": 64, "batch": 128, "d_feat": 16}),
    )


def recsys_cells() -> tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_batch", "train", {"batch": 65_536}),
        ShapeCell("serve_p99", "serve", {"batch": 512}),
        ShapeCell("serve_bulk", "serve", {"batch": 262_144}),
        ShapeCell("retrieval_cand", "retrieval",
                  {"batch": 1, "n_candidates": 1 << 20, "d_cand": 64}),
    )


# ------------------------------------------------------------- input specs
def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _lm_specs(arch: ArchConfig, cell: ShapeCell):
    from repro_torch.models.transformer import decode_cache_on
    m = arch.model
    b, s = cell.dims["batch"], cell.dims["seq"]
    if cell.kind == "train":
        batch = {"tokens": _sds((b, s), torch.int32),
                 "targets": _sds((b, s), torch.int32)}
        specs = {"tokens": P(DATA, None), "targets": P(DATA, None)}
        return batch, specs, {}
    if cell.kind == "prefill":
        batch = {"tokens": _sds((b, s), torch.int32)}
        specs = {"tokens": P(DATA, None)}
        return batch, specs, {}
    # decode: cache + one token (cache dtype follows param dtype)
    cache = decode_cache_on(m, b, s, m.param_dtype, _META)
    if b == 1:
        # long-context single-request decode: S over model only (a single
        # mesh axis keeps the size-1 cache write partitionable), head_dim
        # over data (flash-decoding-style partial attention both ways).
        cache_spec = P(None, None, "model", None, "data")
        tok_spec = P(None, None)
    else:
        cache_spec = P(None, DATA, "model", None, None)
        tok_spec = P(DATA, None)
    cache_specs = {
        "k": cache_spec, "v": cache_spec,
        "k_front": cache_spec, "v_front": cache_spec,
        "len": P(),
    }
    batch = {"token": _sds((b, 1), torch.int32), "cache": cache}
    specs = {"token": tok_spec, "cache": cache_specs}
    return batch, specs, {}


def _gnn_specs(arch: ArchConfig, cell: ShapeCell):
    m = arch.model
    d = cell.dims
    if cell.name in ("molecule", "smoke_molecule"):
        n = d["n"] * d["batch"]
        e = d["e"] * d["batch"]
        n_graphs = d["batch"]
        pooled = True
    else:
        n, e = d["n"], d["e"]
        n_graphs = 1
        pooled = False
    # pad for sharding on the big cells; small cells stay replicated.
    # Edges shard over BOTH mesh axes: per-layer (E, d) message tensors are
    # the GNN activation hog and edges have no model-axis conflict.
    big = n >= 100_000
    n_p = pad_to(n) if big else n
    e_p = pad_to(e) if big else e
    node_spec = P(DATA, None) if big else P(None, None)
    flat_spec = P(DATA) if big else P(None)
    edge_spec = P(None, DATA + ("model",)) if big else P(None, None)

    batch = {"edge_index": _sds((2, e_p), torch.int32)}
    specs = {"edge_index": edge_spec}
    statics = {"n_graphs": n_graphs, "pool": pooled}

    if m.kind == "nequip":
        batch.update(positions=_sds((n_p, 3), torch.float32),
                     species=_sds((n_p,), torch.int32),
                     node_graph=_sds((n_p,), torch.int32),
                     labels=_sds((n_graphs,), torch.float32))
        specs.update(positions=node_spec, species=flat_spec,
                     node_graph=flat_spec,
                     labels=P(DATA) if n_graphs >= 128 else P(None))
        return batch, specs, statics

    batch.update(x=_sds((n_p, d["d_feat"]), torch.float32))
    specs.update(x=node_spec)
    if pooled:
        batch.update(node_graph=_sds((n_p,), torch.int32),
                     labels=_sds((n_graphs,), torch.float32))
        specs.update(node_graph=flat_spec,
                     labels=P(DATA) if n_graphs >= 128 else P(None))
    else:
        batch.update(labels=_sds((n_p,), torch.int32),
                     label_mask=_sds((n_p,), torch.float32),
                     node_graph=_sds((n_p,), torch.int32))
        specs.update(labels=flat_spec, label_mask=flat_spec,
                     node_graph=flat_spec)
    return batch, specs, statics


def _recsys_specs(arch: ArchConfig, cell: ShapeCell):
    m = arch.model
    b = cell.dims["batch"]
    big = b >= 512
    bs = P(DATA) if big else P(None)
    batch = {
        "sparse_ids": _sds((b, m.n_sparse), torch.int32),
        "bag_ids": _sds((b, m.bag_fields, m.bag_size), torch.int32),
        "dense": _sds((b, m.n_dense), torch.float32),
    }
    specs = {
        "sparse_ids": P(DATA, None) if big else P(None, None),
        "bag_ids": P(DATA, None, None) if big else P(None, None, None),
        "dense": P(DATA, None) if big else P(None, None),
    }
    if cell.kind == "train":
        batch["labels"] = _sds((b,), torch.float32)
        specs["labels"] = bs
    if cell.kind == "retrieval":
        nc, dc = cell.dims["n_candidates"], cell.dims["d_cand"]
        n_fields = m.n_sparse + 1
        batch["candidates"] = _sds((nc, dc), torch.float32)
        batch["retrieval_proj"] = _sds((n_fields * m.d_attn, dc),
                                       torch.float32)
        specs["candidates"] = P(DATA + ("model",), None)
        specs["retrieval_proj"] = P(None, None)
    return batch, specs, {}


def input_specs(arch: ArchConfig, cell_name: str):
    """-> (batch tree of meta tensors, partition specs, statics)."""
    cell = arch.cell(cell_name)
    if arch.family == "lm":
        return _lm_specs(arch, cell)
    if arch.family == "gnn":
        return _gnn_specs(arch, cell)
    if arch.family == "recsys":
        return _recsys_specs(arch, cell)
    raise ValueError(arch.family)


def decode_hint_specs(arch: ArchConfig, cell: ShapeCell):
    """Per-layer cache + logits PartitionSpecs for decode shard hints."""
    b = cell.dims["batch"]
    if b == 1:
        cache = P(None, "model", None, "data")    # (B, S, Hkv, Dh)
        logits = P(None, None, None, None, "model")   # (B, Hkv, G, 1, S)
    else:
        cache = P(DATA, "model", None, None)
        logits = P(DATA, None, None, None, "model")
    return {"cache": cache, "logits": logits}


def resolve_for_mesh(spec_tree, mesh):
    """Drop mesh axes that don't exist (e.g. 'pod' on a single-pod mesh).
    ``mesh`` is a ``DeviceMesh`` or a mapping of axis names to sizes."""
    names = set(mesh_axis_sizes(mesh))

    def fix_entry(e):
        if e is None:
            return None
        if isinstance(e, str):
            return e if e in names else None
        kept = tuple(a for a in e if a in names)
        return kept if kept else None

    return map_specs(lambda p: P(*(fix_entry(e) for e in p)), spec_tree)
