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

With ``--ddp`` it runs data-parallel training instead: reduced
smollm-360m at batch 8 (4 x 32 tokens a rank) through
``train.ddp.build_ddp_step``, int8-compressed and plain, 3 steps each
after one untimed step, s/step on each rank, and the all-reduce's payload
bytes against f32's. Rank 0 then trains the same model one-card on the
whole batches (``train.step.build_train_step``): the plain DDP run's
losses, parameters and moments must be within ``1e-5`` of each leaf's
largest magnitude of it, every rank's parameters equal rank 0's.
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


_DDP_RANK = r'''
import json, sys, time
import torch
import torch.distributed as dist
rank, world, addr, device, out = sys.argv[1:6]
rank, world = int(rank), int(world)
on_card = device == "cuda"
if on_card:
    torch.cuda.set_device(rank)
dev = torch.device(f"cuda:{rank}" if on_card else "cpu")
dist.init_process_group("nccl" if on_card else "gloo", init_method=addr,
                        rank=rank, world_size=world)
import dataclasses
from repro_torch.configs import ShapeCell, reduced_config
from repro_torch.data.synthetic import make_batch
from repro_torch.models.transformer import build_lm
from repro_torch.train.ddp import build_ddp_step, init_ddp_state
from repro_torch.train.step import build_train_step, _state, state_leaves
STEPS = 3
arch = reduced_config("smollm-360m")
arch = dataclasses.replace(arch, cells=(ShapeCell(
    "ddp_train", "train", {"seq": 32, "batch": 2 * world}),))
batches = [make_batch(arch, "ddp_train", 50 + i, device="cpu")
           for i in range(STEPS + 1)]
def model():
    return build_lm(arch.model, device="cpu",
                    generator=torch.Generator().manual_seed(0))
def sync():
    if on_card:
        torch.cuda.synchronize(dev)
def leaves(state):
    return {"/".join(map(str, p)): get().detach().cpu().double()
            for p, get in state_leaves(state)}
res = {}
for compress in (True, False):
    state = init_ddp_state(model(), device=dev)
    fn = build_ddp_step(arch, compress=compress)
    losses = []
    warm = init_ddp_state(model(), device=dev)
    fn(warm, {k: v.to(dev) for k, v in batches[0].items()})   # untimed
    del warm
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, m = fn(state, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
    sync()
    sec = (time.perf_counter() - t0) / STEPS
    n = sum(p.numel() for p in state["params"].parameters())
    n_leaves = sum(1 for p, _ in state_leaves(state) if p[0] == "params")
    res["int8" if compress else "f32"] = dict(
        losses=losses, s_per_step=sec, n=n, leaves=n_leaves,
        params={k: v.sum().item() for k, v in leaves(state).items()
                if k.startswith("params")})
    if not compress:
        plain = leaves(state)
if rank == 0:
    one = _state(model().to(dev))
    step = build_train_step(arch)
    losses = []
    for b in batches[1:]:
        one, m = step(one, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
    want = leaves(one)
    worst = 0.0
    for k, w in want.items():
        if k == "opt/step":
            assert int(w) == int(plain[k]), k
            continue
        scale = w.abs().max().item()
        err = (plain[k] - w).abs().max().item()
        assert err <= 1e-5 * scale + 1e-12, (k, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    res["one_card"] = dict(losses=losses, worst=worst)
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''


def _ddp_report(ranks) -> bool:
    """Print the DDP runs; -> whether they agree (the one-card check ran
    in rank 0, which fails on a difference)."""
    one = ranks[0]["one_card"]
    ok = True
    for mode in ("int8", "f32"):
        rows = [r[mode] for r in ranks]
        same = all(r["params"] == rows[0]["params"] for r in rows)
        ok &= same
        n, leaves = rows[0]["n"], rows[0]["leaves"]
        payload = 4 * n + 4 * leaves if mode == "int8" else 4 * n
        print(f"[multicard] ddp reduced smollm-360m batch "
              f"{2 * len(ranks)} {mode}: s_per_step="
              f"{[r['s_per_step'] for r in rows]} losses="
              f"{rows[0]['losses']} all-reduce payload {payload} B a step "
              f"({'int8 values summed as int32, ' + str(leaves) + ' leaf maxima' if mode == 'int8' else 'f32'}; "
              f"f32 {4 * n} B); parameters "
              f"{'equal on every rank' if same else 'DIFFER across ranks'}",
              flush=True)
    print(f"[multicard] ddp plain against one card over the whole batch: "
          f"losses {one['losses']} against {ranks[0]['f32']['losses']}, "
          f"largest leaf error {one['worst']:.3e} of its largest magnitude",
          flush=True)
    return ok


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
    ap.add_argument("--ddp", action="store_true",
                    help="run data-parallel training instead of counting")
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
    if args.ddp:
        cmds = {f"rank{r}": [sys.executable, "-c", _DDP_RANK, str(r),
                             str(args.ranks), addr, args.device,
                             str(tmp / f"rank{r}.json")]
                for r in range(args.ranks)}
    else:
        cmds = {f"rank{r}": [
            sys.executable, "-c", _RANK, str(r), str(args.ranks), addr,
            str(args.side), args.device, str(tmp / f"rank{r}.json"),
            json.dumps([MESHES, ITERS])] for r in range(args.ranks)}
    done = run_all(cmds, env, tmp, args.timeout)
    failed = {name: rc for name, (rc, _, _) in done.items() if rc != 0}
    if failed:
        for name, rc in failed.items():
            print(f"[multicard] {name} exit {rc}:\n"
                  f"{done[name][2][-3000:]}", file=sys.stderr)
        return 1
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(args.ranks)]
    if args.ddp:
        return 0 if _ddp_report(ranks) else 1
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
