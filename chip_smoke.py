"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (the kernels are built at first use from
``src/repro_torch/csrc``) and nothing of JAX. In order it prints:

1. the card's name and power limit (``nvidia-smi``);
2. the kernels' build time and ptxas' register counts;
3. each CUDA kernel against its plain PyTorch version on the card, at the
   main path's shapes (the u12 plan on ``grid_2d(1024, 1024)``), B=1 and
   B=4, f32 and bf16 storage: error against the stated tolerance, kernel
   and plain times, the kernel's bound, and for the SpMM the time of
   ``torch.sparse.mm`` on the CSR adjacency as a yardstick;
4. whole-path parity: u12 on ``grid_2d(64, 64)``, 8 colorings, the card's
   engine against the CPU engine (plain versions);
5. the full-size slice: ``repro_torch.api.count(grid_2d(1024, 1024),
   "u12", max_iters=8, memory_budget_bytes=32 GiB)``, with each kernel's
   launches in that run (all must be > 0) and the peak device memory;
6. where the time goes: one batch of that query under ``torch.profiler``,
   device time by kernel and the device's idle share;
7. one JSON line with every kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line; without a card
(or without the package beside this file) it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
F32_RTOL = 1e-6                # integer inputs: both sides are exact in f32
BF16_RTOL = 1e-2               # bf16 storage rounds the stored results
PATH_RTOL = 1e-5               # f32 sums past 2^24 taken in another order
GIB = 1 << 30


def _sync():
    import torch
    torch.cuda.synchronize()


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _errors(got, want) -> tuple[float, float]:
    """(max abs error, max error relative to max(|want|, 1)), row block by
    row block so no full-size difference tensor is allocated."""
    g2 = got.reshape(-1, got.shape[-1])
    w2 = want.reshape(-1, want.shape[-1])
    abs_err = rel_err = 0.0
    step = max(1, (1 << 26) // max(1, g2.shape[-1]))
    for r0 in range(0, g2.shape[0], step):
        d = (g2[r0:r0 + step].float() - w2[r0:r0 + step].float()).abs()
        scale = w2[r0:r0 + step].float().abs().clamp_min(1.0)
        abs_err = max(abs_err, d.max().item())
        rel_err = max(rel_err, (d / scale).max().item())
    return abs_err, rel_err


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"({_build._build_dir()})")
    log = _build._build_dir() / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if line.startswith("==") or "Used" in line:
                print(f"[build]   {line.strip()}")


def phase_kernels(g, n_iters_fast: int = 10) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch

    from repro_torch.core.colorsets import split_tables
    from repro_torch.graph.coloring import batch_colorings
    from repro_torch.kernels.ema import ops as ema_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda")
    n = g.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    # CSR adjacency for the torch.sparse.mm yardstick (A is symmetric, so
    # (M @ A)^T = A @ M^T)
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(g.indptr, device=dev),
        torch.as_tensor(g.indices.astype("int64"), device=dev),
        torch.ones(g.m, device=dev), size=(n, n), check_invariants=True)

    def rand(shape, dt):
        return torch.randint(0, 4, shape, generator=gen, device=dev).to(dt)

    def splits(t, t_a):
        return [torch.as_tensor(a, dtype=torch.int32, device=dev)
                for a in split_tables(12, t, t_a)]

    for dt in (torch.float32, torch.bfloat16):
        prep = spmm_ops.prepare(g, dtype=dt, device=dev)
        item = dt.itemsize
        print(f"[kernel] BSR operand ({dt}): n={n} m={g.m} "
              f"blocks={prep.n_blocks} tiles={prep.n_tiles} "
              f"bytes={prep.blocks.numel() * item} "
              f"nnz_per_block={g.m / prep.n_blocks:.1f}", flush=True)
        # the least adjacency bytes the product needs: its nonzeros as
        # int32 CSR, not the dense block stream the kernels are given
        adj_bytes = 4 * (n + 1 + g.m)
        tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
        for b in (1, 4):
            cases = []
            # --- SpMM on the leaf table (the y-cache SpMM of u12's leaf)
            cols = batch_colorings(0, range(b), n, 12, device=dev)
            leaf = (torch.arange(12, device=dev)[:, None]
                    == cols[:, None, :]).to(dt)
            rows = 12 * b
            leaf_t = leaf.reshape(rows, n).t().contiguous().float()
            cases.append(dict(
                name="spmm_bsr", shape=f"m=({b},12,{n})",
                kernel=lambda: spmm_ops.spmm(leaf, prep),
                plain=lambda: spmm_ops.spmm_plain(leaf, prep),
                bytes=2 * leaf.numel() * item + adj_bytes,
                flops=2 * g.m * rows,
                library=(lambda: torch.sparse.mm(csr, leaf_t))
                if dt == torch.float32 else None))
            # --- eMA at u12 node 6: Ca=924, Cp=12, S=792, L=7
            ia6, ip6 = splits(7, 6)
            m_a6, y_p6 = rand((b, 924, n), dt), rand((b, 12, n), dt)
            cases.append(dict(
                name="ema", shape=f"m_a=({b},924,{n}) y_p=({b},12,{n}) "
                                  f"S=792 L=7",
                kernel=lambda: ema_ops.ema(m_a6, y_p6, ia6, ip6),
                plain=lambda: ema_ops.ema_plain(m_a6, y_p6, ia6, ip6),
                bytes=(m_a6.numel() + y_p6.numel() + b * 792 * n) * item
                + 8 * ia6.numel(),
                flops=2 * b * 792 * 7 * n, library=None))
            for case in cases:
                results[(case["name"], dt, b)] = _measure(case, tol,
                                                          n_iters_fast)
            del cases, m_a6, y_p6, leaf, leaf_t
            torch.cuda.empty_cache()
            # --- fused at u12 node 5: Ca=12, Cp=792, S=924, L=6
            ia5, ip5 = splits(6, 1)
            m_a5, m_p5 = rand((b, 12, n), dt), rand((b, 792, n), dt)
            case = dict(
                name="fused_spmm_ema",
                shape=f"m_a=({b},12,{n}) m_p=({b},792,{n}) S=924 L=6",
                kernel=lambda: fused_ops.fused_spmm_ema(m_a5, m_p5, ia5, ip5,
                                                        prep),
                plain=lambda: fused_ops.fused_spmm_ema_plain(
                    m_a5, m_p5, ia5, ip5, prep),
                bytes=(m_a5.numel() + m_p5.numel() + b * 924 * n) * item
                + adj_bytes + 8 * ia5.numel(),
                flops=2 * g.m * 792 * b + 2 * b * 924 * 6 * n, library=None)
            results[(case["name"], dt, b)] = _measure(case, tol, 3)
            del case, m_a5, m_p5
            torch.cuda.empty_cache()
        del prep
        torch.cuda.empty_cache()
    return results


def _measure(case: dict, tol: float, reps: int) -> dict:
    """Run the kernel and its plain version once each, compare, then time
    them (the kernel over ``reps`` runs, the plain version over one)."""
    import torch
    got = case["kernel"]()
    want = case["plain"]()
    _sync()
    abs_err, rel_err = _errors(got, want)
    del got, want
    torch.cuda.empty_cache()
    ms = _time_ms(case["kernel"], reps)
    plain_ms = _time_ms(case["plain"], 1)
    lib_ms = None
    if case["library"]:
        case["library"]()                  # first call sets up cuSPARSE
        lib_ms = _time_ms(case["library"], reps)
    bound_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ops = case["flops"] / F32_FLOPS_PER_S * 1e3
    row = dict(max_abs_err=abs_err, max_rel_err=rel_err, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(bound_bytes, bound_ops),
               bound_by="bytes" if bound_bytes >= bound_ops else "operations")
    lib = f"{lib_ms:.3f}" if lib_ms is not None else "n/a"
    print(f"[kernel] {case['name']:<15} {case['shape']:<48} "
          f"max_rel_err={rel_err:.3e} (tol {tol:g}) "
          f"max_abs_err={abs_err:.3e} kernel_ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.3f} "
          f"({row['bound_by']}) library_ms={lib}", flush=True)
    if not rel_err <= tol:
        raise AssertionError(f"{case['name']} disagrees with its plain "
                             f"version: {rel_err} > {tol}")
    return row


def phase_parity() -> None:
    """u12 on grid_2d(64, 64), 8 colorings: card engine vs CPU engine."""
    import torch

    from repro_torch.core.engines import CountingEngine
    from repro_torch.graph.coloring import batch_colorings
    from repro_torch.graph.generators import grid_2d

    g = grid_2d(64, 64)
    cols = batch_colorings(0, range(8), g.n, 12, device="cuda")
    card = CountingEngine(g, "u12", plan="optimized", device="cuda")
    host = CountingEngine(g, "u12", plan="optimized", device="cpu")
    t_card, r_card = card.count_colorful_batch(cols)
    t_host, r_host = host.count_colorful_batch(cols)
    _sync()
    torch.testing.assert_close(t_card.cpu(), t_host, rtol=PATH_RTOL, atol=0)
    torch.testing.assert_close(r_card.cpu(), r_host, rtol=PATH_RTOL, atol=0)
    print(f"[parity] u12 grid_2d(64,64) 8 colorings: card totals "
          f"{t_card.tolist()} == CPU totals (rtol {PATH_RTOL:g}); root "
          f"tables agree; fused nodes "
          f"{[i for i, v in card.fusion_report.items() if v == 'admitted']}",
          flush=True)


def phase_full(g) -> dict:
    """The slice at full size through the user's entry point."""
    import torch

    from repro_torch import api
    from repro_torch.kernels.ema import ops as ema_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    counters = {"spmm_bsr": spmm_ops.spmm, "ema": ema_ops.ema,
                "fused_spmm_ema": fused_ops.fused_spmm_ema}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = api.count(g, "u12", max_iters=8, memory_budget_bytes=32 * GIB,
                    seed=0)
    _sync()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"[full] u12 on grid_2d(1024,1024) n={g.n} m={g.m}: "
          f"estimate={res.estimate!r} stderr={res.stderr!r} "
          f"iterations={res.iterations} "
          f"s_per_coloring={res.seconds / res.iterations:.4f} "
          f"(count loop {res.seconds:.3f} s, with engine build "
          f"{wall:.3f} s) launches={launches} "
          f"max_memory_allocated={peak} ({peak / GIB:.2f} GiB)", flush=True)
    if not (math.isfinite(res.estimate) and res.estimate > 0
            and res.iterations == 8):
        raise AssertionError(f"bad estimate {res}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return launches


def phase_profile(g) -> None:
    """Where the time goes: one batch of 4 colorings of the full-size query
    under ``torch.profiler``; device time by kernel and the device's idle
    share of the host wall time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api

    q = api.CompiledQuery(g, api.CountQuery(
        template="u12", max_iters=4, round_size=4,
        memory_budget_bytes=32 * GIB))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q.run()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0, None
    for a, b in sorted(spans):           # union of kernel intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    print(f"[profile] u12 grid_2d(1024,1024) batch of 4: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, "
          f"idle share {1 - busy / wall_us:.3f}", flush=True)
    for name, us in by_name.most_common(8):
        print(f"[profile]   {us / 1e3:10.2f} ms  {name[:100]}", flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays IEEE
    torch.backends.cudnn.allow_tf32 = False
    print(_device_line(), flush=True)
    from repro_torch.graph.generators import grid_2d

    phase_build()
    _sync()
    g = grid_2d(1024, 1024)
    kern = phase_kernels(g)
    _sync()
    phase_parity()
    _sync()
    launches = phase_full(g)
    _sync()
    phase_profile(g)
    _sync()
    replaces = {
        "spmm_bsr": ("src/repro_torch/csrc/spmm_bsr.cu",
                     "src/repro/kernels/spmm/pallas_bsr.py:59"),
        "ema": ("src/repro_torch/csrc/ema.cu",
                "src/repro/kernels/ema/pallas_ema.py:74"),
        "fused_spmm_ema": ("src/repro_torch/csrc/fused_spmm_ema.cu",
                           "src/repro/kernels/fused/pallas_fused.py:143"),
    }
    rows = []
    for name, (source, rep) in replaces.items():
        m = kern[(name, torch.float32, 4)]     # the full run's shapes
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
