"""Distributed PGBSC across cards: one rank a card under NCCL, each mesh's
per-iteration sums held bit for bit against the single-device gather
engine's on the same colorings. Run on a machine with four cards:

    python3 tools/dist_multicard.py [--ranks 4] [--side 1024]

It starts ``--ranks`` processes (rank r on card r) joined by
``init_process_group("nccl", init_method="tcp://localhost:<free port>")``
and counts u12 (``plan="dedup"``) on ``grid_2d(side, side)``, iterations
0-3, seed 0, on the meshes (2, 2) as ("data", "model"), (2, 2, 1) as
("pod", "data", "model") and (4, 1) and (1, 4) as ("data", "model"):
seconds per iteration after one untimed iteration, the peak on each card
beside the memory model's tables a rank plus the most a rank holds
beyond them (``DistributedPgbsc.transient_bytes``: the children gathered
over ``model``, the scatter form's partial sums, the ring's blocks in
flight and the gather kernel's scratch), and the gather SpMM and
eMA launches of each rank. Rank 0 then runs
``CountingEngine(..., spmm_method="gather", fuse_spmm_ema=False)`` on its
card and every sum must equal it. The ranks run together for at most
600 s (``repro_torch.launch.ranks.run_all``); a failed rank stops the
others. With ``--device cpu`` the ranks run on gloo
and the kernels' plain versions (a rehearsal off the card). Exits
non-zero if a rank fails or a sum differs.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.ranks import run_all  # noqa: E402
MESHES = [((2, 2), ("data", "model")), ((2, 2, 1), ("pod", "data", "model")),
          ((4, 1), ("data", "model")), ((1, 4), ("data", "model"))]
ITERS = [0, 1, 2, 3]

_RANK = r'''
import json, sys, time
import torch
import torch.distributed as dist
rank, world, addr, side, device, out = sys.argv[1:7]
rank, world, side = int(rank), int(world), int(side)
on_card = device == "cuda"
if on_card:
    torch.cuda.set_device(rank)
dist.init_process_group("nccl" if on_card else "gloo", init_method=addr,
                        rank=rank, world_size=world)
from repro_torch.core.distributed import DistributedPgbsc, coloring_for_seed
from repro_torch.core.engines import CountingEngine
from repro_torch.core.executor import simulate_peak_rows
from repro_torch.graph.generators import grid_2d
from repro_torch.kernels.ema import ops as ema_ops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.launch.mesh import make_mesh
MESHES, ITERS = json.loads(sys.argv[7])
g = grid_2d(side, side)
res = {}
for shape, axes in MESHES:
    if torch.tensor(shape).prod().item() != world:
        continue
    d = DistributedPgbsc(g, "u12", make_mesh(shape, axes, device=device),
                         plan="dedup")
    d.count_iterations([ITERS[0]], seed=0)            # untimed
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    spmm_ops.spmm_gather.launches = ema_ops.ema.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    _, per = d.count_iterations(ITERS, seed=0)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res[str(tuple(shape))] = dict(
        per=per, s_per_iteration=wall / len(ITERS),
        peak=torch.cuda.max_memory_allocated() if on_card else None,
        launches=dict(spmm_gather=spmm_ops.spmm_gather.launches,
                      ema=ema_ops.ema.launches),
        forms=d.collective_choice(), n_pad=d.n_pad, block=d.block,
        model=simulate_peak_rows(d.plan, d.k, d.exec_schedule) * d.n_pad * 4
        // (d.d_data * d.d_model), transient=d.transient_bytes())
    del d
    if on_card:
        torch.cuda.empty_cache()
if rank == 0:
    eng = CountingEngine(g, "u12", plan="dedup", spmm_method="gather",
                         fuse_spmm_ema=False, device=device)
    res["engine"] = {it: float(eng.count_colorful(coloring_for_seed(
        it, g.n, g.n, 12, device=device)[:g.n])[0]) for it in ITERS}
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < args.ranks:
            print(f"dist_multicard: needs {args.ranks} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="dist_multicard_"))
    addr = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = run_all({f"rank{r}": [
        sys.executable, "-c", _RANK, str(r), str(args.ranks), addr,
        str(args.side), args.device, str(tmp / f"rank{r}.json"),
        json.dumps([MESHES, ITERS])] for r in range(args.ranks)},
        env, tmp, args.timeout)
    failed = {name: rc for name, (rc, _, _) in done.items() if rc != 0}
    if failed:
        for name, rc in failed.items():
            print(f"[multicard] {name} exit {rc}:\n"
                  f"{done[name][2][-3000:]}", file=sys.stderr)
        return 1
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(args.ranks)]
    want = {int(k): v for k, v in ranks[0].pop("engine").items()}
    ok = True
    for mesh, row in ranks[0].items():
        sums = [{int(k): v for k, v in r[mesh]["per"].items()} for r in ranks]
        same = all(s == want for s in sums)
        ok &= same
        print(f"[multicard] mesh {mesh} n_pad={row['n_pad']} block="
              f"{row['block']} forms={row['forms']} s_per_iteration="
              f"{[r[mesh]['s_per_iteration'] for r in ranks]} peak="
              f"{[r[mesh]['peak'] for r in ranks]} (model's tables a rank "
              f"{row['model']} + the transient {row['transient']} = "
              f"{row['model'] + row['transient']}) launches="
              f"{[r[mesh]['launches'] for r in ranks]} sums={sums[0]} "
              f"{'equal' if same else 'DIFFER from'} the gather engine's "
              f"{want}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
