"""Run the dry run's grid in parallel processes, one a record.

    PYTHONPATH=src python3 tools/dryrun_grid.py --jobs 6 \\
        [--arch all] [--cell all] [--mesh both] [--out results/dryrun_torch]

Each (arch, cell, mesh) runs as ``python -m repro_torch.launch.dryrun
--arch A --cell C --mesh M --out OUT --skip-existing`` in a process of its
own, at most ``--jobs`` at once, the LM training and prefill cells and the
multi-pod mesh first (they take longest). A record this tree and torch
already wrote is kept (the launcher's ``--skip-existing`` reads its
``source`` stamp). Each child's exit code, seconds and peak resident
memory (``os.wait4``'s ``ru_maxrss``) go to ``OUT/grid_log.jsonl``, one
line a record, and the grid's wall time to a last line. Exits 0 when every
record of the grid is ``ok`` and carries this tree's stamp. The tree is
the one ``PYTHONPATH`` names, for the children too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as dr


def grid(arch: str, cell: str, mesh: str) -> list[tuple[str, str, str]]:
    """The (arch, cell, mesh) records the launcher's filters name, the
    longest expected first."""
    archs = list(ARCH_IDS) + ["pgbsc"] if arch == "all" else arch.split(",")
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    out = []
    for a in archs:
        cfg = None if a in ("pgbsc", "pgbsc-opt") else get_config(a)
        cells = list(dr.PGBSC_CELLS) if cfg is None else \
            [c.name for c in cfg.cells]
        for c in cells:
            if cell != "all" and c not in cell.split(","):
                continue
            kind = "pgbsc" if cfg is None else cfg.cell(c).kind
            lm = cfg is not None and cfg.family == "lm"
            rank = 0 if lm and kind == "train" else 1 if lm and \
                kind == "prefill" else 2
            out += [(rank, m != "multi", a, c, m) for m in meshes]
    return [t[2:] for t in sorted(out)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--cell", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    log = open(os.path.join(args.out, "grid_log.jsonl"), "a")
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "1"))
    todo = grid(args.arch, args.cell, args.mesh)
    running: dict[int, tuple] = {}
    t0 = time.time()
    while todo or running:
        while todo and len(running) < args.jobs:
            a, c, m = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--cell", c, "--mesh", m, "--out", args.out,
                   "--skip-existing"]
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
            running[p.pid] = (p, f"{a}__{c}__{m}", time.time())
        pid, status, usage = os.wait4(-1, 0)
        if pid not in running:
            continue
        p, tag, start = running.pop(pid)
        p.returncode = os.waitstatus_to_exitcode(status)
        line = {"record": tag, "rc": p.returncode,
                "seconds": round(time.time() - start, 1),
                "peak_rss_bytes": usage.ru_maxrss * 1024}
        print(json.dumps(line), flush=True)
        log.write(json.dumps(line) + "\n")
        log.flush()
    wall = round(time.time() - t0, 1)
    # a tree older than the stamp: count its ok records
    stamp = getattr(dr, "source_stamp", lambda: None)()
    ok = 0
    for a, c, m in grid(args.arch, args.cell, args.mesh):
        try:
            rec = json.loads(Path(args.out, f"{a}__{c}__{m}.json")
                             .read_text())
        except (OSError, ValueError):
            continue
        ok += bool(rec.get("ok")) and rec.get("source") == stamp
    n = len(grid(args.arch, args.cell, args.mesh))
    line = {"grid_wall_s": wall, "records": n, "ok_this_tree": ok,
            "jobs": args.jobs, "source": stamp}
    print(json.dumps(line), flush=True)
    log.write(json.dumps(line) + "\n")
    log.close()
    return 0 if ok == n else 1


if __name__ == "__main__":
    sys.exit(main())
