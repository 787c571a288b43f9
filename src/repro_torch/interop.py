"""Carry a JAX engine's state into the port.

The JAX package hands its state over as numpy arrays (the port never
imports it): the graph's CSR arrays, the BSR block stream of its SpMM or
fused prep (``np.asarray(engine._spmm_prep.arrays[...])``), the split
tables of its plan nodes (``engine._splits``) and, for a multi-template
bundle, its fused plan's roots (``engine.roots``). These functions turn them
into the port's ``Graph``, BSR operand (the carried blocks' nonzero index:
the dense blocks stay on the host) and split tables on a device, and
:func:`engine_from_state` builds a port engine that runs on exactly that
state instead of rebuilding it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engines import CountingEngine
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.kernels.spmm import ops as spmm_ops

__all__ = ["graph_from_arrays", "bsr_from_arrays", "splits_from_arrays",
           "engine_from_state"]


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
