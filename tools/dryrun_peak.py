"""What is alive at the peak of one dry-run record's trace.

    PYTHONPATH=src python3 tools/dryrun_peak.py ARCH CELL MESH \\
        [--top 25] [--json OUT] [--reduced] [--batch N --microbatches M]

Traces the record ``python -m repro_torch.launch.dryrun --arch ARCH
--cell CELL --mesh MESH`` writes (MESH ``single`` or ``multi``; or a
reduced config's cell with ``--reduced``, or the cell's batch cut with
``--batch N [--microbatches M]``, MESH then a shape such as ``2x2``;
``smollm-360m train_4k 1x1 --batch 4 --microbatches 2`` is
``chip_smoke.py``'s T1 step as its (Y3) traces it) and prints the
``--top`` largest storages alive on rank 0 when the trace's live bytes
peaked: the op that made each, its local shape, dtype, the placements of
the DTensor that held it, and its bytes; then the live bytes summed by
the op that made them. The record's own memory (arguments +
temporaries) comes first.

It wraps ``analysis/hlo._Storages`` from the outside: each storage that
joins or leaves the live set is logged as an event, the event at which
the peak was reached is kept, and the live set there is rebuilt from the
log after the trace, so the trace's cost grows with its ops, not with
ops times live storages. A storage's placements come from the DTensors
built over it (``DTensor.__new__``); arguments show as ``argument``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from collections import defaultdict


class PeakLog:
    """The storages' events of one trace and where its peak was."""

    def __init__(self):
        self.events: list = []          # (+1, uid, info) or (-1, uid)
        self.uid_of: dict[int, int] = {}   # id(storage) -> live uid
        self.placements: dict[int, str] = {}
        self.peak_at = 0
        self.peak = 0
        self.op = "argument"
        self.storages = None

    def live_at_peak(self) -> list[dict]:
        live = {}
        for ev in self.events[:self.peak_at]:
            if ev[0] > 0:
                live[ev[1]] = ev[2]
            else:
                live.pop(ev[1], None)
        out = []
        for uid, info in live.items():
            out.append({**info, "placements": self.placements.get(uid, "-")})
        return sorted(out, key=lambda r: -r["bytes"])


@contextlib.contextmanager
def peak_log():
    """Log the live storages of every trace run inside (the last trace's
    log is the one kept) -> the :class:`PeakLog`."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    from repro_torch.analysis import hlo
    log = PeakLog()
    store_add, store_drop = hlo._Storages.add, hlo._Storages._drop
    dispatch = hlo._RankZero.__torch_dispatch__
    new = DTensor.__new__
    counter = iter(range(1, 1 << 62))

    def add(self, tree):
        if log.storages is not self:     # a new trace: a new log
            log.__init__()
            log.storages = self
        before = set(self.live)
        store_add(self, tree)
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            local = hlo._local(t)
            key = id(local.untyped_storage())
            if key in before or key in log.uid_of or key not in self.live:
                continue
            uid = next(counter)
            log.uid_of[key] = uid
            log.events.append((1, uid, {
                "op": log.op, "shape": list(local.shape),
                "dtype": str(local.dtype).replace("torch.", ""),
                "bytes": self.live[key]}))
        if self.peak > log.peak:
            log.peak = self.peak
            log.peak_at = len(log.events)

    def drop(self, key):
        store_drop(self, key)
        uid = log.uid_of.pop(key, None)
        if uid is not None:
            log.events.append((-1, uid))

    def torch_dispatch(self, func, types, args=(), kwargs=None):
        log.op = f"{func.namespace}::{func._schema.name.split('::')[-1]}"
        return dispatch(self, func, types, args, kwargs)

    def dtensor_new(cls, local_tensor, spec, **kw):
        uid = log.uid_of.get(id(local_tensor.untyped_storage()))
        if uid is not None and uid not in log.placements:
            log.placements[uid] = "(" + ", ".join(
                str(p) for p in spec.placements) + ")"
        return new(cls, local_tensor, spec, **kw)

    hlo._Storages.add, hlo._Storages._drop = add, drop
    hlo._RankZero.__torch_dispatch__ = torch_dispatch
    DTensor.__new__ = dtensor_new
    try:
        yield log
    finally:
        hlo._Storages.add, hlo._Storages._drop = store_add, store_drop
        hlo._RankZero.__torch_dispatch__ = dispatch
        DTensor.__new__ = new


def summary(log: PeakLog, top: int) -> dict:
    live = log.live_at_peak()
    by_op = defaultdict(int)
    for r in live:
        by_op[r["op"]] += r["bytes"]
    return {"peak_bytes": log.peak,
            "live_bytes": sum(r["bytes"] for r in live),
            "largest": live[:top],
            "by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1]))}


def trace(arch_id: str, cell: str, mesh: str, reduced: bool = False,
          batch: int | None = None, microbatches: int | None = None) -> dict:
    """The record's trace: the launcher's (``run_cell``), or with
    ``reduced`` or ``batch`` given, the (reduced) config's cell, its batch
    cut to ``batch``, on a mesh given as a shape (``2x2``, ``1x1``)."""
    import dataclasses

    from repro_torch.analysis import hlo
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch import dryrun as dr
    if not reduced and batch is None:
        return dr.run_cell(arch_id, cell, mesh)
    arch = reduced_config(arch_id) if reduced else get_config(arch_id)
    if batch is not None:
        c = arch.cell(cell)
        arch = dataclasses.replace(arch, cells=(dataclasses.replace(
            c, dims={**c.dims, "batch": batch}),))
    shape = tuple(int(s) for s in mesh.split("x"))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    world = math.prod(shape)
    with dr.fake_world(world):
        dev = hlo.trace_device(autograd=True)
        m = dr._mesh(shape, axes, dev)
        return dr.trace_arch(dr._moe_grouped(arch, m), cell, m, world, dev,
                             microbatches=microbatches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("cell")
    ap.add_argument("mesh")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    with peak_log() as log:
        rec = trace(args.arch, args.cell, args.mesh, args.reduced,
                    args.batch, args.microbatches)
    if not rec.get("ok"):
        print(json.dumps(rec)[:4000])
        return 1
    m = rec["memory"]
    out = {"record": f"{args.arch}__{args.cell}__{args.mesh}",
           "argument_bytes": m["argument_bytes"],
           "temp_bytes": m["temp_bytes"],
           "arg_plus_temp_bytes": m["argument_bytes"] + m["temp_bytes"],
           "ran_whole": rec["ran_whole"], "trace_s": rec["compile_s"],
           **summary(log, args.top)}
    print(f"{out['record']}: argument {out['argument_bytes']} B + temp "
          f"{out['temp_bytes']} B = {out['arg_plus_temp_bytes']} B "
          f"(peak of live storages {out['peak_bytes']} B); ran_whole "
          f"{out['ran_whole']}; trace {out['trace_s']} s")
    print(f"{'bytes':>16}  {'dtype':<9} {'op':<34} {'placements':<42} "
          f"local shape")
    for r in out["largest"]:
        print(f"{r['bytes']:>16}  {r['dtype']:<9} {r['op']:<34} "
              f"{r['placements']:<42} {tuple(r['shape'])}")
    print("live bytes at the peak by the op that made them:")
    for op, b in out["by_op"].items():
        print(f"{b:>16}  {op}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
