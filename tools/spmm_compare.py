"""Times the two SpMM kernels and path B of whichever ``repro_torch`` is
importable, on one H100, by ``chip_smoke.py``'s own measurement.

Run it once per tree to compare two versions of the port in one call:

    PYTHONPATH=<tree>/src python3 tools/spmm_compare.py --label <name> \
        [--hub-sweep] [--graph-cache build/rmat20.npz]

It prints, each line tagged with ``--label``:

* the BSR SpMM (``spmm_ops.spmm`` on ``prepare(g, "bsr")``) on
  ``grid_2d(1024, 1024)`` at u12's leaf table ``(4, 12, n)`` and at the
  k=10 census's passive table ``(2, 252, n)``, f32 and bf16; the gather
  SpMM on ``rmat(20)`` at path B's leaf ``(7, 12, n)`` (f32, bf16) and
  node 3 ``(7, 220, n)`` (f32). Each is checked against its plain version
  and timed by ``chip_smoke._measure`` (one untimed call, then CUDA-event
  means), so every tree is timed the same way;
* path B (``CountingEngine(rmat(20), "u12", spmm_method="gather",
  fuse_spmm_ema=False)``, 48 GiB) three times over 8 colorings: seconds
  per coloring, the caching allocator's retries and peak memory of each
  run, then one batch under ``torch.profiler`` (``chip_smoke._profile``:
  busy time, idle share, host CUDA calls, retries);
* with ``--hub-sweep`` (trees whose gather operand has hub segments): the
  gather SpMM with its hub runs cut at other degrees, ``n`` meaning none.

``--graph-cache`` keeps ``rmat(20)``'s CSR in an ``.npz`` so that later
runs skip its ~100 s host build. It exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rmat20(cache: str | None):
    import numpy as np

    from repro_torch.graph.generators import rmat
    from repro_torch.graph.structure import Graph
    if cache and Path(cache).exists():
        z = np.load(cache)
        return Graph(n=int(z["n"]), indptr=z["indptr"], indices=z["indices"])
    g = rmat(20)
    if cache:
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, n=g.n, indptr=g.indptr, indices=g.indices)
    return g


def _case(name, shape, kernel, plain, m, g):
    """A ``chip_smoke._measure`` case: the bound counts the table read and
    written once and the adjacency as int32 CSR; no library call."""
    return dict(name=name, shape=shape, kernel=kernel, plain=plain,
                bytes=2 * m.numel() * m.element_size() + 4 * (g.n + 1 + g.m),
                flops=2 * g.m * (m.numel() // g.n), library=None)


def bsr_rows(sm, label: str) -> None:
    import torch

    from repro_torch.graph.generators import grid_2d
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda")
    g = grid_2d(1024, 1024)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        prep = spmm_ops.prepare(g, dtype=dt, device=dev)
        tol = sm.F32_RTOL if dt == torch.float32 else sm.BF16_RTOL
        for shape in ((4, 12, g.n), (2, 252, g.n)):
            m = torch.randint(0, 4, shape, generator=gen, device=dev).to(dt)
            sm._measure(_case(
                f"{label}:spmm_bsr", f"m={shape} {dt}",
                lambda: spmm_ops.spmm(m, prep),
                lambda: spmm_ops.spmm_plain(m, prep), m, g), tol, 10)
            del m
            torch.cuda.empty_cache()
        del prep
        torch.cuda.empty_cache()


def gather_rows(sm, label: str, g, batch: int, sweep: bool) -> None:
    import torch

    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    prep = spmm_ops.prepare(g, "gather", device=dev)
    for dt, rows in ((torch.float32, 12), (torch.bfloat16, 12),
                     (torch.float32, 220)):
        tol = sm.F32_RTOL if dt == torch.float32 else sm.BF16_RTOL
        m = torch.randint(0, 4, (batch, rows, g.n), generator=gen,
                          device=dev).to(dt)
        sm._measure(_case(
            f"{label}:spmm_gather", f"m=({batch},{rows},{g.n}) {dt}",
            lambda: spmm_ops.spmm(m, prep),
            lambda: spmm_ops.spmm_gather_plain(m, prep), m, g), tol, 3)
        # the hubs' tail: the leaf in f32 at every cut, else uncut only
        cuts = ()
        if sweep:
            cuts = ((g.n, 2048, 512, 128, 64)
                    if (dt, rows) == (torch.float32, 12) else (g.n,))
        for hub in cuts:
            other = spmm_ops._gather_prep(g, dev, hub_degree=hub)
            sm._measure(_case(
                f"{label}:hub_sweep", f"m=({batch},{rows},{g.n}) {dt} "
                f"hub_degree={hub} ({other.n_segments} segments)",
                lambda: spmm_ops.spmm(m, other),
                lambda: spmm_ops.spmm_gather_plain(m, prep), m, g), tol, 3)
            del other
        del m
        torch.cuda.empty_cache()


def path_b(sm, label: str, g, runs: int = 3) -> int:
    import torch

    from repro_torch.core.engines import CountingEngine

    torch.cuda.empty_cache()
    eng = CountingEngine(g, "u12", plan="optimized", spmm_method="gather",
                         fuse_spmm_ema=False,
                         memory_budget_bytes=sm.CENSUS_BUDGET)
    stats = torch.cuda.memory_stats
    for run in range(runs):
        torch.cuda.reset_peak_memory_stats()
        retries = stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        est = eng.estimate(8)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"[{label}] path B run {run}: s_per_coloring={secs / 8:.4f} "
              f"count={est['count']!r} batch={eng.batch_size} allocator "
              f"retries={stats().get('num_alloc_retries', 0) - retries} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()}",
              flush=True)
    b = eng.batch_size
    sm._profile(f"{label} path B batch of {b}",
                lambda: eng.count_iterations_batch(range(b)))
    return b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--hub-sweep", action="store_true")
    ap.add_argument("--graph-cache")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("spmm_compare: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sm = _smoke()
    sm.phase_peaks()        # the kernel rows' measured bounds read PEAKS
    import repro_torch
    print(f"[{args.label}] {sm._device_line()} repro_torch from "
          f"{Path(repro_torch.__file__).parent}", flush=True)
    bsr_rows(sm, args.label)
    t0 = time.perf_counter()
    g = _rmat20(args.graph_cache)
    print(f"[{args.label}] rmat(20) n={g.n} m={g.m} ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    batch = path_b(sm, args.label, g)
    torch.cuda.empty_cache()
    gather_rows(sm, args.label, g, batch, args.hub_sweep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
