"""Carry a JAX engine's state, and a JAX model's weights, into the port.

The JAX package hands its state over as numpy arrays (the port never
imports it): the graph's CSR arrays, the BSR block stream of its SpMM or
fused prep (``np.asarray(engine._spmm_prep.arrays[...])``), the split
tables of its plan nodes (``engine._splits``) and, for a multi-template
bundle, its fused plan's roots (``engine.roots``). These functions turn them
into the port's ``Graph``, BSR operand (the carried blocks' nonzero index:
the dense blocks stay on the host) and split tables on a device, and
:func:`engine_from_state` builds a port engine that runs on exactly that
state instead of rebuilding it.

The reference's models hand over their parameter pytree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``): nested dicts and lists
whose paths are the port modules' parameter names (``layers.0.nbr.w`` is
``params["layers"][0]["nbr"]["w"]``; the port's ``self_`` is the
reference's ``self``). An LM's scanned ``layers`` are stacked along a
leading axis in the reference and a list of blocks in the port: they are
unstacked on the way in and restacked on the way out.
:func:`gnn_from_params`, :func:`nequip_from_params`,
:func:`lm_from_params` and :func:`autoint_from_params` build the port's
module on those weights, :func:`params_to_arrays` gives them back in the
reference's layout, :func:`decode_cache_from_arrays` and
:func:`decode_cache_to_arrays` carry an LM decode cache, and
:func:`adamw_state_from_arrays` loads the reference's AdamW state
(``{"mu", "nu", "step"}``) into the port's :class:`AdamW`.

A whole train state crosses with :func:`train_state_from_arrays` and
:func:`train_state_to_arrays`: the reference's ``{"params", "opt"[,
"residual"]}`` pytree of numpy leaves, bfloat16 leaves kept bfloat16 (as
their ``uint16`` bits on the way out; ``ml_dtypes`` bfloat16 arrays or
``uint16`` bits on the way in), so a state crosses bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engines import CountingEngine
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models.equivariant import build_nequip
from repro_torch.models.gnn import build_gnn
from repro_torch.models.recsys import build_autoint
from repro_torch.models.transformer import LM, build_lm

__all__ = ["graph_from_arrays", "bsr_from_arrays", "splits_from_arrays",
           "engine_from_state", "gnn_from_params", "nequip_from_params",
           "lm_from_params", "autoint_from_params", "params_to_arrays",
           "decode_cache_from_arrays", "decode_cache_to_arrays",
           "adamw_state_from_arrays", "train_state_from_arrays",
           "train_state_to_arrays"]


def graph_from_arrays(n: int, indptr, indices) -> Graph:
    """The port's host graph from CSR arrays."""
    return Graph(n=int(n), indptr=np.asarray(indptr, np.int64),
                 indices=np.asarray(indices, np.int32))


def bsr_from_arrays(n: int, arrays: dict, *, dtype=torch.float32,
                    device=None) -> spmm_ops.BsrPrep:
    """The port's BSR operand from a reference prep's ``blocks``,
    ``src_tile`` and ``dst_tile`` arrays: their nonzero index on
    ``device``; the blocks are read on the host and not kept."""
    return spmm_ops.from_arrays(
        int(n), np.array(arrays["blocks"]), arrays["src_tile"],
        arrays["dst_tile"], dtype=dtype, device=resolve_device(device))


def splits_from_arrays(splits: dict, *, device=None) -> dict:
    """``{plan node: (IA, IP)}`` as int32 tensors on ``device``."""
    dev = resolve_device(device)
    return {int(idx): tuple(torch.as_tensor(np.array(t, np.int32),
                                            device=dev) for t in pair)
            for idx, pair in splits.items()}


def engine_from_state(template, *, n: int, indptr, indices, bsr: dict,
                      splits: dict, roots=None, device=None, **engine_kw
                      ) -> CountingEngine:
    """A port engine on the carried graph, BSR stream and split tables.

    ``template`` may be one template or a list of same-k templates (a
    bundle engine); for a bundle, ``roots`` are the reference fused plan's
    root node indices (``engine.roots``), which must name the port's own
    plan roots, so the carried split tables index the same nodes. The
    carried arrays must describe the same operand the port would build
    (same block count, tile and nonzero count, and split-table shapes); the
    engine then runs on them as given. ``engine_kw`` are
    :class:`CountingEngine` keywords.
    """
    g = graph_from_arrays(n, indptr, indices)
    eng = CountingEngine(g, template, device=device, **engine_kw)
    if roots is not None and tuple(int(r) for r in roots) != eng.roots:
        raise ValueError(f"carried roots {tuple(roots)} do not match the "
                         f"fused plan's {eng.roots}")
    current = eng._spmm_prep if isinstance(eng._spmm_prep, spmm_ops.BsrPrep) \
        else eng._fused_prep
    if current is None:
        raise ValueError("this engine walks no BSR operand to carry over")
    prep = bsr_from_arrays(n, bsr, dtype=eng.dtype, device=eng.device)
    tables = splits_from_arrays(splits, device=eng.device)
    shape = (prep.n_blocks, prep.tile, tuple(prep.col_ptr.shape), prep.nnz)
    want = (current.n_blocks, current.tile, tuple(current.col_ptr.shape),
            current.nnz)
    if shape != want:
        raise ValueError(f"carried BSR stream (blocks, tile, col_ptr, "
                         f"nonzeros) {shape} does not fit this graph {want}")
    if sorted(tables) != sorted(eng._splits) or any(
            tables[i][0].shape != eng._splits[i][0].shape for i in tables):
        raise ValueError("carried split tables do not match the plan")
    if eng._spmm_prep is current:
        eng._spmm_prep = prep
    if eng._fused_prep is current:
        eng._fused_prep = prep
    eng._splits = tables
    return eng


# ------------------------------------------------------------ model weights
def _ref_path(name: str) -> tuple:
    """A port parameter name -> its path in the reference's pytree."""
    return tuple(int(p) if p.isdigit() else ("self" if p == "self_" else p)
                 for p in name.split("."))


def _leaf_paths(tree, prefix=()) -> set:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix}
    return set().union(*(_leaf_paths(v, prefix + (k,)) for k, v in items))


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _load(module, params):
    """Copy the reference's pytree ``params`` into ``module``'s
    parameters, which must name exactly its leaves at their shapes."""
    named = dict(module.named_parameters())
    have, want = {_ref_path(n) for n in named}, _leaf_paths(params)
    if have != want:
        raise ValueError(f"parameter trees differ: the port's has "
                         f"{sorted(map(str, have - want))} of its own, the "
                         f"carried one {sorted(map(str, want - have))}")
    with torch.no_grad():
        for name, p in named.items():
            a = _lookup(params, _ref_path(name))
            if a.shape != tuple(p.shape):
                raise ValueError(f"{name}: carried shape {a.shape}, the "
                                 f"port's {tuple(p.shape)}")
            p.copy_(torch.from_numpy(a.astype(np.float32)).to(p.dtype))
    return module


def gnn_from_params(cfg, params, d_in: int, *, device=None):
    """The port's :class:`~repro_torch.models.gnn.GNN` of ``cfg`` holding
    the reference's ``init_gnn`` parameters ``params`` (numpy leaves)."""
    return _load(build_gnn(cfg, d_in, device=device), params)


def nequip_from_params(cfg, params, *, device=None):
    """The port's :class:`~repro_torch.models.equivariant.NequIP` of
    ``cfg`` holding the reference's ``init_nequip`` parameters."""
    n_species = np.asarray(params["species_embed"]).shape[0]
    return _load(build_nequip(cfg, n_species, device=device), params)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _unstack(tree) -> list:
    """A pytree of arrays stacked along axis 0 -> a list of pytrees."""
    n = {_lookup(tree, p).shape[0] for p in _leaf_paths(tree)}
    if len(n) != 1:
        raise ValueError(f"stacked layer leaves disagree on depth: {n}")
    return [_map_leaves(lambda a, i=i: np.asarray(a)[i], tree)
            for i in range(n.pop())]


def _stack(trees: list):
    """The inverse of :func:`_unstack`."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def lm_from_params(cfg, params, *, device=None) -> LM:
    """The port's :class:`~repro_torch.models.transformer.LM` of ``cfg``
    holding the reference's ``init_lm`` parameters ``params`` (numpy
    leaves), its stacked ``layers`` unstacked into the block list."""
    layers = params["layers"]
    carried = dict(params, layers=_unstack(layers) if layers else [])
    return _load(build_lm(cfg, device=device), carried)


def autoint_from_params(cfg, params, *, device=None):
    """The port's :class:`~repro_torch.models.recsys.AutoInt` of ``cfg``
    holding the reference's ``init_autoint`` parameters."""
    return _load(build_autoint(cfg, device=device), params)


def decode_cache_from_arrays(cache: dict, *, device=None) -> dict:
    """The reference's decode cache (numpy ``k``, ``v``, ``k_front``,
    ``v_front``, ``len``) as the port's, on ``device``; bfloat16 arrays
    stay bfloat16."""
    dev = resolve_device(device)
    out = {}
    for key, a in cache.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[key] = t.to(dev)
    out["len"] = out["len"].to(torch.int32)
    return out


def decode_cache_to_arrays(cache: dict) -> dict:
    """The port's decode cache as numpy arrays (bfloat16 as float32)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in cache.items()}


def params_to_arrays(module) -> dict:
    """``module``'s parameters as the reference's pytree of numpy arrays
    (bfloat16 ones as float32); an LM's ``layers`` stacked along axis 0
    and its ``dense_front`` a list, empty where it has none."""
    root: dict = {}
    for name, p in module.named_parameters():
        *head, last = _ref_path(name)
        node = root
        for k in head:
            node = node.setdefault(k, {})
        t = p.detach().cpu()
        node[last] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    tree = lists(root)
    if isinstance(module, LM):
        tree["layers"] = _stack(tree["layers"]) if len(module.layers) else {}
        tree.setdefault("dense_front", [])
    return tree


def adamw_state_from_arrays(opt, state: dict) -> None:
    """Load the reference's AdamW state ``{"mu", "nu", "step"}`` (numpy
    leaves) into ``opt``, an :class:`~repro_torch.optim.optimizer.AdamW`
    built from ``named_parameters()``, so its next step is the
    reference's next step."""
    step = int(np.asarray(state["step"]))
    for group in opt.param_groups:
        if "param_names" not in group:
            raise ValueError("build the AdamW from module.named_parameters() "
                             "to carry the reference's state into it")
        group["step"] = step
        for name, p in zip(group["param_names"], group["params"]):
            path = _ref_path(name)
            opt.state[p] = {
                k: torch.from_numpy(_lookup(state[k], path).astype(
                    np.float32)).to(p.device) for k in ("mu", "nu")}


# -------------------------------------------------------------- train state
def _tensor_of(a) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (``ml_dtypes``) arrays and
    ``uint16`` bits become bfloat16, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def train_state_from_arrays(arch, tree: dict, d_in: int | None = None, *,
                            device=None) -> dict:
    """The port's train state (:mod:`repro_torch.train.step`) on
    ``device`` holding the reference's ``{"params", "opt"[,
    "residual"]}`` of numpy leaves, bit for bit; a GNN's ``d_in`` is read
    off its input layer when not given."""
    from repro_torch.train.step import (concrete_train_state,
                                        load_state_leaves, tree_leaves)
    if d_in is None and arch.family == "gnn" and arch.model.kind != "nequip":
        d_in = np.asarray(tree["params"]["embed"]["w"]).shape[0]
    state = concrete_train_state(arch, 0, d_in, device=device)
    if "residual" in tree:
        state["residual"] = {
            n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in state["params"].named_parameters()}
    return load_state_leaves(state, [_tensor_of(a)
                                     for _, a in tree_leaves(tree)])


def train_state_to_arrays(state: dict) -> dict:
    """The port's train state as the reference's pytree of numpy arrays
    (an LM's layers stacked, the step a 0-d int32); bfloat16 leaves are
    ``uint16`` arrays of their bits (``a.view(ml_dtypes.bfloat16)`` reads
    them), every other leaf keeps its dtype."""
    from repro_torch.train.step import state_tree

    def arr(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return _map_leaves(arr, state_tree(state))
