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
reference's ``self``). :func:`gnn_from_params` and
:func:`nequip_from_params` build the port's module on those weights,
:func:`params_to_arrays` gives them back in the reference's layout, and
:func:`adamw_state_from_arrays` loads the reference's AdamW state
(``{"mu", "nu", "step"}``) into the port's :class:`AdamW`.
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

__all__ = ["graph_from_arrays", "bsr_from_arrays", "splits_from_arrays",
           "engine_from_state", "gnn_from_params", "nequip_from_params",
           "params_to_arrays", "adamw_state_from_arrays"]


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


def params_to_arrays(module) -> dict:
    """``module``'s parameters as the reference's pytree of numpy arrays
    (bfloat16 ones as float32)."""
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
    return lists(root)


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
