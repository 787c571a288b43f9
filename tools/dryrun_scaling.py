"""Trace the reduced nequip (2 layers, d 16) on one big cell of ``n``
nodes and ``e`` edges, to see how the dry run's trace scales with the
edge count.

    PYTHONPATH=src python3 tools/dryrun_scaling.py --n 100000 \\
        --e 25600,2560000 [--mesh 16x16] [--timeout 300]

A cell of ``n >= 100,000`` shards as the registry's big GNN cells do
(edges over every mesh axis). Prints one JSON line a size: trace seconds,
flops, bytes and collective bytes a rank, argument + temp bytes, and the
largest real tensor DTensor's bookkeeping made (``bookkeeping_bytes``).
``--timeout`` ends the process (exit 124) after that many seconds of one
trace, printing where it was; each size runs in a process of its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def trace(n: int, e: int, shape: tuple[int, ...]) -> dict:
    from repro_torch.analysis import hlo
    from repro_torch.configs import ShapeCell, reduced_config
    from repro_torch.launch import dryrun as dr
    arch = dataclasses.replace(reduced_config("nequip"), cells=(
        ShapeCell("big", "train", {"n": n, "e": e, "d_feat": 6}),))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")
    world = math.prod(shape)
    with dr.fake_world(world):
        dev = hlo.trace_device(autograd=True)
        mesh = dr._mesh(shape, axes, dev)
        rec = dr.trace_arch(arch, "big", mesh, world, dev)
    r, m = rec["roofline"], rec["memory"]
    return {"n": n, "e": e, "mesh": "x".join(map(str, shape)),
            "ok": rec["ok"], "trace_s": rec["compile_s"],
            "flops": r["flops"], "bytes": r["bytes"],
            "collective_bytes": r["collective_bytes"],
            "arg_plus_temp_bytes": m["argument_bytes"] + m["temp_bytes"],
            "bookkeeping_bytes": rec.get("bookkeeping_bytes"),
            "source": getattr(dr, "source_stamp", dict)()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--e", default="25600,2560000")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.mesh.split("x"))
    if args.one:
        import faulthandler
        faulthandler.dump_traceback_later(args.timeout, exit=True)
        print(json.dumps(trace(args.n, int(args.e), shape)), flush=True)
        return 0
    rc = 0
    for e in args.e.split(","):
        res = subprocess.run(
            [sys.executable, __file__, "--one", "--n", str(args.n), "--e", e,
             "--mesh", args.mesh, "--timeout", str(args.timeout)],
            capture_output=True, text=True)
        lines = [s for s in res.stdout.splitlines() if s.startswith("{")]
        if res.returncode or not lines:
            rc = 124
            where = [s for s in res.stderr.splitlines() if "File" in s][:3]
            print(json.dumps({"n": args.n, "e": int(e), "mesh": args.mesh,
                              "ok": False, "timeout_s": args.timeout,
                              "rc": res.returncode, "where": where}),
                  flush=True)
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
