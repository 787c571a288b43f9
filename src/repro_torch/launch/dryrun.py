"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes and record rank 0's flops, bytes, collectives, ops and
memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --cell train_4k --mesh single --out results/dryrun_torch

The counterpart of the JAX package's ``launch/dryrun.py``, with its CLI,
cell names, file names and record keys. Where the reference lowers and
compiles each cell over 256 or 512 forced host devices and reads XLA's
analyses, the port starts a ``"fake"`` process group of 256 (16x16,
``single``) or 512 (2x16x16, ``multi``) ranks, builds the mesh, then
traces one train or serve step (or one PGBSC coloring) as rank 0 on fake
tensors (``analysis/hlo``): nothing is allocated and nothing runs on a
card. One JSON per (arch, cell, mesh), written through a ``.tmp`` file,
so independent processes can split the grid. ``--arch pgbsc`` traces the
paper's own distributed counting walk (RMAT-1M) through the gather SpMM
and eMA ops; ``pgbsc-opt`` the same on the optimized plan.

The record's departures from the reference's: ``compile_s`` holds the
trace's seconds; ``memory.generated_code_bytes`` is ``null`` (nothing is
compiled); ``hlo_ops`` holds :func:`~repro_torch.analysis.hlo.count_ops`
of the trace; ``extrapolation`` is ``null``, since an LM's layers are a
Python loop and every layer is traced (the reference extrapolates from
two unrolled compiles because XLA counts a scanned layer once); and
``peaks`` names the card peaks the roofline divides by; ``ran_whole``
counts the ops DTensor has no sharding strategy for, which the trace ran
on gathered inputs on every rank (``analysis/hlo``);
``bookkeeping_bytes`` is the largest real tensor DTensor's own
bookkeeping made while the step was traced. Every record, failed ones
too, carries ``source`` (:func:`source_stamp`): the hash of the
``repro_torch`` tree that wrote it and the torch version, since a
record's counts follow both (DTensor picks other strategies in another
version). ``--skip-existing`` keeps only an ``ok`` record of this tree
and torch.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import hlo
from repro_torch.analysis.roofline import (H100_SXM, model_flops,
                                           roofline_from_trace)
from repro_torch.configs import ARCH_IDS, get_config, input_specs, \
    resolve_for_mesh
from repro_torch.configs.shapes import decode_hint_specs

__all__ = ["PGBSC_CELLS", "run_cell", "trace_pgbsc", "trace_arch", "main",
           "fake_world", "source_stamp"]

PGBSC_CELLS = {
    # paper workloads: (graph n, directed edge slots, template)
    "gs20_u5": {"n": 600_000, "e": 62_000_000, "template": "u5"},
    "rmat1m_u7": {"n": 1_000_000, "e": 400_000_000, "template": "u7"},
    "rmat1m_u10": {"n": 1_000_000, "e": 400_000_000, "template": "u10"},
    "rmat1m_u12": {"n": 1_000_000, "e": 400_000_000, "template": "u12"},
}
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
PACKAGE = Path(__file__).resolve().parents[1]


def tree_hash(root: Path = PACKAGE) -> str:
    """sha256 of a source tree's contents: each file's path relative to
    ``root`` and its bytes, in sorted order (``__pycache__`` left out), so
    the hash names the code whatever commit or checkout holds it."""
    h = hashlib.sha256()
    files = sorted(p for p in Path(root).rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    for p in files:
        rel = p.relative_to(root).as_posix().encode()
        data = p.read_bytes()
        h.update(b"%d:%s%d:" % (len(rel), rel, len(data)))
        h.update(data)
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def _package_hash() -> str:
    return tree_hash()


def source_stamp() -> dict:
    """What wrote a record: the ``repro_torch`` tree's :func:`tree_hash`
    (taken once a process) and the running torch version."""
    return {"tree": _package_hash(), "torch": torch.__version__}


@contextlib.contextmanager
def fake_world(world_size: int):
    """The default process group as a ``"fake"`` one of ``world_size``
    ranks, this process rank 0 (collectives return at once and move
    nothing); destroyed on exit."""
    import torch.distributed as dist
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, axes, device: torch.device):
    """The mesh over the fake group, built before any fake mode is
    entered (a mesh built inside one reads its ranks from fake
    tensors)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=axes)


def run_cell(arch_id: str, cell_name: str, mesh_kind: str) -> dict:
    from repro_torch.train import op_sharding
    op_sharding.install()
    shape, axes = MESHES[mesh_kind]
    chips = math.prod(shape)
    t0 = time.time()
    with fake_world(chips):
        if arch_id in ("pgbsc", "pgbsc-opt"):
            mesh = _mesh(shape, axes, torch.device("cuda"))
            rec = trace_pgbsc(cell_name, mesh, chips,
                              plan="optimized" if arch_id == "pgbsc-opt"
                              else "dedup")
        else:
            dev = hlo.trace_device(autograd=True)
            mesh = _mesh(shape, axes, dev)
            rec = trace_arch(_moe_grouped(get_config(arch_id), mesh),
                             cell_name, mesh, chips, dev)
    rec.update(arch=arch_id, cell=cell_name, mesh=mesh_kind, chips=chips,
               wall_s=round(time.time() - t0, 1))
    return rec


def _microbatches_for(arch, cell) -> int:
    """Gradient-accumulation factor per train cell (activation memory):
    the reference's 8 for an LM's train cell (at most its batch, for a
    reduced cell's batch of 2), else 1."""
    if arch.family == "lm" and cell.kind == "train" and \
            getattr(arch.model, "scan_layers", True):
        return math.gcd(8, cell.dims["batch"])
    return 1


def _moe_grouped(arch, mesh):
    """Set MoE dispatch groups = data-shard count (GShard grouping)."""
    m = arch.model
    if getattr(m, "moe", None) is None:
        return arch
    g = 1
    for ax in ("pod", "data"):
        if ax in mesh.mesh_dim_names:
            g *= mesh.size(mesh.mesh_dim_names.index(ax))
    return dataclasses.replace(
        arch, model=dataclasses.replace(
            m, moe=dataclasses.replace(m.moe, groups=g)))


def cell_step(arch, cell_name: str, mesh, device, *,
              microbatches: int | None = None):
    """-> (step, its arguments, the arguments' tree): one train or serve
    step of ``arch``'s cell with the abstract state and batch as DTensors
    on ``mesh`` at the reference's specs (plain tensors on a one-rank
    mesh), each rank's shard an empty tensor on ``device``. Call inside
    the fake mode. A train step takes ``microbatches`` (default
    :func:`_microbatches_for`); an LM's decode step takes the reference's
    decode hints (``configs/shapes.decode_hint_specs``), as its
    ``_lower_cell`` passes them."""
    from repro_torch.train import step as st
    cell = arch.cell(cell_name)
    meta_batch, bspecs, statics = input_specs(arch, cell_name)
    bspecs = resolve_for_mesh(bspecs, mesh)
    batch = st.distribute_tree(meta_batch, bspecs, mesh, device)
    state = st.abstract_train_state(arch, d_in=cell.dims.get("d_feat"))
    state = st.distribute_state(state, mesh, st.state_specs(arch, state,
                                                            mesh), device)
    params = list(state["params"].parameters())
    if cell.kind == "train":
        if microbatches is None:
            microbatches = _microbatches_for(arch, cell)
        step = st.build_train_step(arch, statics=statics,
                                   microbatches=microbatches)
        moments = [m for p in state["opt"].params()
                   for m in state["opt"].state[p].values()]
        return step, (state, batch), (params, moments, batch)
    kind = cell.kind if cell.kind in ("prefill", "decode",
                                      "retrieval") else "serve"
    hints = None
    if arch.family == "lm" and cell.kind == "decode":
        hints = resolve_for_mesh(decode_hint_specs(arch, cell), mesh)
    serve = st.build_serve_step(arch, kind, statics=statics,
                                shard_hints=hints)
    return serve, (state["params"], batch), (params, batch)


def trace_arch(arch, cell_name: str, mesh, chips: int, device,
               microbatches: int | None = None) -> dict:
    """Trace one (arch, cell) step on ``mesh`` as rank 0 -> the record."""
    from torch.distributed.tensor.experimental import implicit_replication
    mode = FakeTensorMode()
    with mode:
        step, args, arguments = cell_step(arch, cell_name, mesh, device,
                                          microbatches=microbatches)
    # tensors a step makes the same on every rank (an arange, a step
    # count) join DTensor ops as replicated
    with implicit_replication():
        _, trace = hlo.trace_step(step, *args, arguments=arguments,
                                  mode=mode)
    return _finalize(trace, chips, mf=model_flops(arch,
                                                  arch.cell(cell_name)))


def trace_pgbsc(cell_name: str, mesh, chips: int, plan: str = "dedup",
                dims: dict | None = None, template: str | None = None
                ) -> dict:
    """Trace one coloring of the distributed PGBSC walk (the abstract
    ``DistributedPgbsc``) as rank 0 -> the record. ``dims`` and
    ``template`` default to the cell's."""
    from repro_torch.core.distributed import DistributedPgbsc
    spec = PGBSC_CELLS.get(cell_name, {})
    dims = dims or {"n": spec["n"], "e": spec["e"]}
    mode = FakeTensorMode()
    with mode:
        dpg = DistributedPgbsc(None, template or spec["template"], mesh,
                               plan=plan, abstract_dims=dims)
        step, args = dpg.count_step_fn()
    with torch.no_grad():
        _, trace = hlo.trace_step(step, *args,
                                  arguments=(dpg.operands(), args),
                                  mode=mode)
    mf = 2.0 * (dpg.plan.n_nodes * dims["e"])  # order-of-magnitude
    return _finalize(trace, chips, mf=mf)


def _finalize(trace, chips: int, mf: float) -> dict:
    roof = roofline_from_trace(trace, chips, H100_SXM)
    per_dev_model_flops = mf / chips
    return {
        "ok": True,
        "compile_s": round(trace.seconds, 1),
        "memory": {
            "argument_bytes": trace.argument_bytes,
            "output_bytes": trace.output_bytes,
            "temp_bytes": trace.temp_bytes,
            "generated_code_bytes": None,
        },
        "roofline": roof.as_dict(),
        "peaks": dataclasses.asdict(H100_SXM),
        "collectives": hlo.collective_summary(trace),
        "hlo_ops": hlo.count_ops(trace),
        "model_flops_global": mf,
        "model_flops_per_device": per_dev_model_flops,
        "useful_flops_ratio": (per_dev_model_flops / roof.flops
                               if roof.flops else None),
        "extrapolation": None,
        "ran_whole": trace.whole,
        "bookkeeping_bytes": trace.bookkeeping_bytes,
    }


def _stamped_here(path: str) -> bool:
    """Whether ``path`` holds an ``ok`` record this tree and torch
    wrote."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return False
    return bool(rec.get("ok")) and rec.get("source") == source_stamp()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) + ["pgbsc"] if args.arch == "all" \
        else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_fail = 0
    for arch_id in archs:
        if arch_id in ("pgbsc", "pgbsc-opt"):
            cells = list(PGBSC_CELLS)
        else:
            cells = [c.name for c in get_config(arch_id).cells]
        if args.cell != "all":
            cells = [c for c in cells if c in args.cell.split(",")]
        for cell in cells:
            for mesh_kind in meshes:
                tag = f"{arch_id}__{cell}__{mesh_kind}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and _stamped_here(path):
                    print(f"[skip] {tag}")
                    continue
                print(f"[run ] {tag}", flush=True)
                try:
                    rec = run_cell(arch_id, cell, mesh_kind)
                except Exception as e:  # noqa: BLE001 — record the failure
                    rec = {"ok": False, "arch": arch_id, "cell": cell,
                           "mesh": mesh_kind, "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    n_fail += 1
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
                rec["source"] = source_stamp()
                with open(path + ".tmp", "w") as f:
                    json.dump(rec, f, indent=1)
                os.replace(path + ".tmp", path)
                if rec.get("ok"):
                    r = rec["roofline"]
                    print(f"[ ok ] {tag} compile={rec['compile_s']}s "
                          f"flops={r['flops']:.3e} bytes={r['bytes']:.3e} "
                          f"coll={r['collective_bytes']:.3e} "
                          f"dom={r['dominant']}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
