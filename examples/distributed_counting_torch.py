"""Fault-tolerant distributed subgraph counting on the PyTorch/CUDA port.

The port's counterpart of ``examples/distributed_counting.py``: PGBSC on a
random graph across a (pod, data, model) mesh of ``torch.distributed``
ranks, the runner checkpointing every 4 iterations (kill it mid-run and
rerun with the same ``--ledger``: it resumes from the ledger). One process
a rank, started together through ``launch/ranks.run_all``: NCCL ranks, a
card each, unless ``--device cpu`` puts gloo ranks on the CPU.

    PYTHONPATH=src python examples/distributed_counting_torch.py \\
        [--device cpu] [--iters 32] [--mesh 2,2,2]
"""

import argparse
import math
import os
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--mesh", default="2,2,2",
                    help="(data, model) or (pod, data, model) ranks")
    ap.add_argument("--n", type=int, default=200, help="graph vertices")
    ap.add_argument("--ledger", default=None,
                    help="ledger directory (default: a new temporary one)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _rank(args, shape) -> None:
    """One rank: join the process group, count, and (rank 0) report."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import count_subgraphs_exact, get_template
    from repro_torch.core.distributed import DistributedPgbsc
    from repro_torch.core.runner import EstimatorRunner, distributed_counter
    from repro_torch.device import resolve_device
    from repro_torch.graph import erdos_renyi
    from repro_torch.launch.mesh import make_mesh

    dev = resolve_device(args.device)
    world = math.prod(shape)
    if dev.type == "cuda":
        torch.cuda.set_device(args.rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(args.store, world),
                            rank=args.rank, world_size=world)
    try:
        g = erdos_renyi(args.n, 6.0, seed=4)
        t = get_template("u5")
        mesh = make_mesh(shape, _AXES[len(shape)], device=dev.type)
        if args.rank == 0:
            print(f"mesh: {dict(zip(_AXES[len(shape)], shape))}  graph: "
                  f"n={g.n} m={g.m}  template: {t}", flush=True)
        runner = EstimatorRunner(
            distributed_counter(DistributedPgbsc(g, t, mesh), seed=3),
            k=t.k, automorphisms=t.automorphisms, n_iterations=args.iters,
            ledger_dir=f"{args.ledger}/rank{args.rank}", checkpoint_every=4,
            seed=3)
        res = runner.run()
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        print(f"estimate={res.count:.5g}  "
              f"colorful_sum={res.colorful_sum:.4g}")
        print(f"iterations done={len(res.completed)}  "
              f"restarts={res.restarts}  elapsed={res.elapsed_s:.1f}s")
        exact = count_subgraphs_exact(g, t)
        print(f"exact={exact}  rel_err={abs(res.count - exact) / exact:.3%}")


def main(argv=None) -> int:
    """Start every rank of ``--mesh`` and wait for them; print rank 0's
    report. -> 0 when every rank exits 0."""
    args = _args(argv)
    shape = tuple(int(s) for s in args.mesh.split(","))
    if len(shape) not in _AXES:
        raise ValueError(f"--mesh takes 2 or 3 sizes, got {args.mesh}")
    if args.rank is not None:
        _rank(args, shape)
        return 0
    from repro_torch.launch.ranks import run_all

    ledger = args.ledger or tempfile.mkdtemp(prefix="pgbsc_ledger_")
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, str(Path(__file__).resolve()),
                "--iters", str(args.iters), "--mesh", args.mesh,
                "--n", str(args.n), "--ledger", ledger,
                "--store", f"{tmp}/store"]
        if args.device:
            base += ["--device", args.device]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
        done = run_all({f"rank{r}": base + ["--rank", str(r)]
                        for r in range(math.prod(shape))},
                       env, Path(tmp), args.timeout)
    print(done["rank0"][1], end="")
    bad = {name: rc for name, (rc, _, _) in done.items() if rc != 0}
    for name in bad:
        print(f"{name} exited {bad[name]}:\n{done[name][2][-2000:]}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
