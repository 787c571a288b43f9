"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (the kernels are built at first use from
``src/repro_torch/csrc``) and nothing of JAX. It drives seventeen paths of
the port, each with every kernel's launch counter set to 0 just before it
and read just after:

* **u12 on a mesh:** ``api.count(grid_2d(1024, 1024), "u12", max_iters=8,
  memory_budget_bytes=32 GiB)`` — BSR SpMM, eMA, fused SpMM->eMA;
* **the k=10 tree census (path A):** all 106 free trees on 10 vertices,
  each rooted at a center, through ``api.compile_query(...).run()`` (what
  ``api.count_many`` runs) on ``grid_2d(1024, 1024)``, ``plan="dedup"``,
  8 colorings, 48 GiB — adds the shared-passive group kernel;
* **u12 on a social graph (path B):** ``CountingEngine(rmat(20), "u12",
  plan="optimized", spmm_method="gather", fuse_spmm_ema=False,
  memory_budget_bytes=48 GiB).estimate(8)`` — gather SpMM and eMA, with no
  BSR operand built;
* **u13 chunked on the mesh:** ``api.count`` (``compile_query(...).run()``)
  of ``u13`` on ``grid_2d(1024, 1024)`` at a 16 GiB budget, 4 colorings:
  the memory model chunks node 5's 1,716 passive colour sets into single
  rows — one BSR SpMM and one chunk-accumulate launch a chunk — beside
  the same colorings unchunked (24 GiB, batch 1);
* **the scrambled mesh:** ``grid_2d(1024, 1024)`` relabelled at random, u12
  over 8 colorings (a) through the gather SpMM as it is, (b) the same with
  ``reorder="rcm"``, (c) ``api.count(..., reorder="rcm")`` on the default
  BSR and fused path;
* **path B relabelled:** path B's engine with ``reorder="degree"``;
* **u12 on the social graph on the defaults:** ``compile_query`` of u12
  on ``rmat(20)`` with the port's default BSR operand and fusion (its
  nonzero index alone on the card), 48 GiB, one full batch of path B's
  size (7 colorings), held against path B's estimate on the same
  colorings;
* **the autotuner:** u12 on the mesh, the k=10 census and u13 chunked at
  16 GiB again with ``engine_kw={"autotune_blocks": True}``, each after a
  warm run whose sweeps are timed apart, estimates bit-equal to the
  untuned runs';
* **(R) the runner:** ``EstimatorRunner(engine_counter(eng, seed=0),
  n_iterations=8, checkpoint_every=3)`` over u12 on the mesh (optimized
  plan, 32 GiB, batch 4), a ledger in a temporary directory: a straight
  run against one cut after 4 iterations and resumed by a new runner, the
  straight run at batch 1 and 4, an injected ``kernel.dispatch`` fault and
  a torn ledger (``faults.active_plan``), every per-iteration sum held
  bit-equal; seconds per coloring beside ``eng.estimate(8)``;
* **(F) the paper's three regimes:** u12 on the mesh, ``plan="plain"``,
  ``CountingEngine(engine="fascia")`` over 2 colorings at 24 GiB,
  ``"pfascia"`` over 4 at 24 GiB and ``"pgbsc"`` (default operands and
  fusion) over 8 at 32 GiB, each in whole batches timed after one untimed
  batch; the row-major engines run torch's ops (no hand-written kernel
  launches), and iterations 0-1 agree across the three;
* **(D) distributed PGBSC:** ``torch.distributed`` on NCCL at world size
  1 (a ``FileStore`` under ``TMPDIR``), mesh ``(1, 1)`` as ``("data",
  "model")``, ``DistributedPgbsc(grid_2d(1024, 1024), "u12",
  plan="dedup").count_iterations([0, 1, 2, 3], seed=0)``: the ring's
  gather SpMM and the eMA in both its forms, every sum equal bit for bit
  to the single-device gather engine's on the same ``coloring_for_seed``
  coloring; at world 1 the only collectives are the float64 totals'
  ``all_reduce``s (the ring has one step, nothing is gathered or
  scattered); the process group is destroyed before (S);
* **(S) the counting service:** the mesh written with
  ``graph/io.save_edge_list`` and loaded with ``load_cached`` (parsed, then
  from its ``.npz``); ``launch/serve.main`` in batch mode on it (u12 under
  three spellings and u10, 8 iterations, 32 GiB): two engine builds for
  four requests, one u12 group, its u12 and u10 estimates equal to
  ``api.count``'s; a
  one-engine ``EngineCache`` releasing evicted operands; the async QoS
  service behind the HTTP front end on an ephemeral port (prewarmed u12,
  three POSTs from two tenants and two classes, polled to their results,
  ``/healthz``, ``/metrics.json``); a u13 request at 16 GiB, chunked as
  above; the k=10 census through ``compile_query(engine_cache=)`` twice,
  built once; and a u12 group whose two injected dispatch faults step its
  degradation ladder to the unfused engine, then one whose four step it to
  level 2 (the gather SpMM kernel), each with the same estimate;
* **(G) the GNNs the motif features feed:** (G0) GraphSAGE, PNA,
  GatedGCN (with and without ``edge_attr``) and NequIP at
  ``configs.reduced_config``, built once on the CPU from a seeded
  generator and copied to the card: forward, loss, every gradient (and
  NequIP's forces) and the loss after 5 AdamW steps against the CPU
  (``rtol 1e-5`` of the largest magnitude; ``1e-4`` after the steps);
  (G1) ``examples/gnn_motif_features_torch.main`` on the card and the
  CPU: equal motif features, final losses within ``rtol 1e-3``; (G2)
  ``api.motif_features(grid_2d(1024, 1024), ["u3", "path4", "star4"],
  n_iters=8)`` on the card's kernels (the path's launch counters), equal
  to the CPU port's, with the eMA and fused kernels held against their
  plain versions at the motif engines' shapes (``at_paths``), then
  graphsage-reddit at its registered width trained full-batch on the
  mesh with those features (20 AdamW steps, the last loss below the
  first), graphsage-reddit on ``data.synthetic.gnn_batch``'s
  ``ogb_products`` (2,449,408 nodes, 61,859,328 edges), pna and gatedgcn
  at ``minibatch_lg`` and nequip at ``molecule`` with forces by autograd;
* **(L) the LM, MoE and AutoInt models** (torch's own ops; no counting
  kernel may launch): (L0) the five LMs and AutoInt at
  ``configs.reduced_config`` in f32, card against CPU from one set of
  parameters: ``lm_forward`` full and blocked (8-token chunks),
  ``lm_prefill_chunked`` then three ``lm_decode_step``s with the cache,
  AutoInt's forward, retrieval scores and loss (``rtol 1e-5`` of the
  largest magnitude); (L1) one block of each kind at its registered
  width in f32 (llama3-8b, gemma3-1b local and global, deepseek-moe-16b's
  dense front and MoE, qwen3's MoE with QK-norm), card against CPU, the
  MoE router's top-k ids equal but for near-ties; (L2)
  ``tests/test_chunked_prefill.py``'s checks at full width in f32 (2 x
  2048, chunk 512) for smollm-360m, gemma3-1b and llama3-8b, and the MoE
  models' correlation check in bf16; (L3) every LM at its registered
  width and depth in bf16: a batch of 8
  prompts of 2,048 tokens through ``lm_prefill_chunked`` (chunk 1024)
  into a 2,080-row cache, then 32 greedy decode steps, llama3-8b also
  ``lm_prefill`` at 1 x 4096; (L4) AutoInt at its registered cells in f32
  (``serve_p99``, ``serve_bulk``, ``retrieval_cand``, ``train_batch``
  forward and loss);
* **(T) training** (torch's own ops; no counting kernel may launch): (T0)
  every registered architecture at ``reduced_config``, card against CPU
  from one CPU-drawn train state: one ``build_train_step`` step (loss,
  ``grad_norm``, ``lr``, parameters and moments, ``rtol 1e-5`` of the
  largest magnitude), five (``1e-4``), and 2 microbatches for smollm-360m
  and AutoInt; (T1) smollm-360m at its registered widths and depth in
  bf16 with remat on ``train_4k`` cut to 16 sequences, 8 microbatches:
  s/step, tokens/s, model TFLOP/s, the peak beside the analytic count, a
  checkpoint (4.09 GB, several shard files) restored bit for bit and
  continued within ``1e-4``; (T2) AutoInt at ``train_batch`` (65,536);
  (T3) ``launch.train.main`` stopped at step 6 and resumed to 10, and its
  GNN and recsys runs; (T4) ``build_ddp_step`` under NCCL at world size 1
  against a gloo group of 1 on the CPU, and T1's model's DDP steps.

In order it prints:

1. the card's name and power limit (``nvidia-smi``);
2. the kernels' build time and ptxas' register counts, then the card's
   measured peaks (``[peaks]``): the larger of a 4 GiB device-to-device
   copy's and a 4 GiB read's rate, and an f32 matmul with TF32 off,
   against which every kernel row's ``bound_ms_measured`` and
   ``roof_fraction`` (``KernelRoofline``, at most 1 or the run fails) are
   read beside the data-sheet ``bound_ms``;
3. each CUDA kernel against its plain PyTorch version on the card, at its
   path's shapes, f32 and bf16 storage: error against the stated
   tolerance, kernel and plain times, the kernel's bound, and for the two
   SpMMs the time of ``torch.sparse.mm`` on the CSR adjacency, alone and
   with the transposes in and out of its ``(n, rows)`` layout inside the
   call. The BSR SpMM also runs at path A's largest unfused passive table,
   and the gather operand's bytes, scratch bytes and hub segments are
   printed. After paths A and B, every eMA, fused and shared-passive
   group shape each launches is timed at its batch beside its bound
   (``[sweep]``), and the costliest of each kernel is held against its
   plain version. The chunk-accumulate kernel is held against its plain
   version at u13 node 5's chunking (f32, bf16) and at 4-row chunks.
   The three tuned kernels (BSR SpMM, gather SpMM, eMA) run every launch
   shape at each shape their paths launch them with (``[tune]``), each
   held against the plain version exactly, and the autotuner's pick is
   printed beside the default;
4. whole-path parity, the card's engine against the CPU engine (plain
   versions): u12 on ``grid_2d(64, 64)``; the k=8 census (23 trees) on
   ``grid_2d(64, 64)`` through ``count_many`` and ``motif_features``; all
   106 estimates of the k=10 census on ``grid_2d(64, 64)``, 2 colorings;
   u12 with ``spmm_method="gather"`` on ``rmat(12)``; FASCIA and PFASCIA
   u12 on ``grid_2d(64, 64)``, 2 colorings; the ``segment``, ``ell`` and
   ``dense`` SpMM backends against the BSR kernel on ``rmat(12)``, each
   run twice and bit-equal to itself;
5. the full-size runs, each with its kernels' launches (each kernel of a
   PGBSC path must launch; the row-major engines launch none), peak
   device memory and seconds per coloring; the chunked run's
   peak beside the model's and the unchunked run's, and the reordered runs'
   occupied blocks and host seconds; (R)'s ``[runner]`` lines and (F)'s
   ``[regime]`` lines: each regime's batch, seconds per coloring, peak
   beside ``exec_choice.peak_bytes`` and ``engine.work.total_flops``, and
   the ratios FASCIA/PGBSC and PFASCIA/PGBSC; ``[autotune]`` lines: the
   tuned runs' seconds per coloring beside the untuned, their sweeps'
   seconds, the winners by shape and the ``autotune_cache_*`` counters;
6. where the time goes: one batch of each full-size path (FASCIA's and
   PFASCIA's among them) under
   ``torch.profiler``, device time and launches by kernel, the device's
   idle share, the host's CUDA calls and the allocator's retries;
7. (D)'s ``[dist]`` lines: seconds per iteration, the peak beside the
   memory model's tables and the ring's operand, the sums; then the
   gather SpMM and eMA at the ring's shapes against their plain versions
   (``[kernel]`` lines, also in the JSON line's ``at_paths``), with the
   scatter form's remap also at ``d_model`` 2 (shard 0: its active half,
   the passive and its zero row);
8. (S)'s ``[service]`` lines: the graph's host load times, serve's own
   output (per-request breakdowns, span summary), the u12 group's seconds
   per coloring beside ``api.count``'s, the cold engine build, peak and
   released device memory, each HTTP request's time from POST to result,
   the prewarm, a cached answer's round trip, and each step's launches;
9. (G)'s ``[gnn parity]`` and ``[gnn example]`` lines, the motif
   engines' ``[sweep]`` lines, and a ``[gnn]`` line per run: the arch, the cell, n, e, the parameter count, seconds
   per step (after one untimed step), ``max_memory_allocated`` (beside
   the analytic peak for GraphSAGE at ``ogb_products``) and the losses,
   after one step under ``torch.profiler``;
10. (L)'s ``[lm]`` lines: each check's largest error; for each LM its
    prefill seconds and tokens/s, decode ms a step, and peak bytes beside
    the analytic model (parameters + cache + the larger of the last
    chunk's logits and one layer's attention scores), with one decode
    step and one prefill chunk of llama3-8b and deepseek-moe-16b under
    ``torch.profiler``; for AutoInt each cell's ms a batch and peak
    beside parameters + batch + activations;
11. (T)'s ``[train]`` lines: T0's largest errors and losses; T1's s/step,
    tokens/s, model TFLOP/s beside a bf16 matmul's measured rate, the peak
    beside ``lm_train_bytes``, the checkpoint's shard files, bytes, write
    and read seconds, the resumed steps' errors, and one step under
    ``torch.profiler``; T2's s/step and peak beside its count; T3's
    resumed loss; T4's errors and s/step with the all-reduce payload;
12. the script's total seconds, one JSON line with every kernel's
    numbers, then the last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line; without a card
(or without the package beside this file) it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
# the card's own rates, measured by phase_peaks: "copy_bw" bytes/s of a
# device-to-device copy (read + write), "read_bw" of the fastest read,
# "bw" the larger of the two, "f32_flops" FLOP/s of an f32 matmul
PEAKS: dict = {}
PEAK_BATCHES = 5          # timed batches a yardstick (``phase_peaks``)
PEAK_WARM_COPIES = 200    # 4 GiB copies before the first, ~0.55 s
# phase_full's peak while the BSR operand still held its dense blocks on
# the card (an NVIDIA H100 80GB HBM3 at 700 W; PERF.md §4)
DENSE_BLOCKS_U12_PEAK = 31_835_362_816
F32_RTOL = 1e-6                # integer inputs: both sides are exact in f32
BF16_RTOL = 1e-2               # bf16 storage rounds the stored results
PATH_RTOL = 1e-5               # f32 sums past 2^24 taken in another order
GIB = 1 << 30
CENSUS_BUDGET = 48 * GIB       # path A and path B memory budget
# the paper's regimes (F): FASCIA's and PFASCIA's split temporaries lie
# outside the memory model (a few (B, N, 792) f32 buffers at u12's widest
# node, 3.3 GB a coloring each), so their budgets leave room for them
FASCIA_BUDGET = 24 * GIB       # batch 2 (10.1 GiB a coloring modeled)
PFASCIA_BUDGET = 24 * GIB      # batch 3 (7.0 GiB a coloring modeled)


# ---------------------------------------------------------------- census
# The tree census: every free tree on k vertices (OEIS A000055: 1, 1, 1, 2,
# 3, 6, 11, 23, 47, 106 for k = 1..10). Pure Python, so the tests load it
# from this file by path.
def _rooted_canon(adj, root, parent=-1):
    return "(" + "".join(sorted(_rooted_canon(adj, u, root)
                                for u in adj[root] if u != parent)) + ")"


def _centers(adj):
    deg = {v: len(nb) for v, nb in adj.items()}
    left = set(adj)
    layer = [v for v in left if deg[v] <= 1]
    while len(left) > 2:
        nxt = []
        for v in layer:
            left.discard(v)
            for u in adj[v]:
                if u in left:
                    deg[u] -= 1
                    if deg[u] == 1:
                        nxt.append(u)
        layer = nxt
    return sorted(left)


def census_trees(k):
    """Every free tree on k vertices, one per isomorphism class, as
    ``(edges, root)`` with ``root`` a center vertex (of two centers, the one
    whose rooted form sorts first). Trees grow by one leaf at a time; a new
    tree is kept when its canonical form (the least rooted form over its
    centers) is new."""
    trees = {"()": ((), 0)}
    for size in range(2, k + 1):
        grown = {}
        for edges, _ in trees.values():
            for v in range(size - 1):
                new = edges + ((v, size - 1),)
                adj = {u: [] for u in range(size)}
                for a, b in new:
                    adj[a].append(b)
                    adj[b].append(a)
                forms = sorted((_rooted_canon(adj, c), c)
                               for c in _centers(adj))
                key = forms[0][0]
                if key not in grown:
                    grown[key] = (new, forms[0][1])
        trees = grown
    return [trees[key] for key in sorted(trees)]


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
    row block so no full-size difference tensor is allocated; tuples of
    tables (a group's outputs) are compared pair by pair."""
    if isinstance(got, tuple):
        errs = [_errors(a, b) for a, b in zip(got, want)]
        return max(e[0] for e in errs), max(e[1] for e in errs)
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


def _step_cost(b: int, n: int, c_a: int, c_p: int, s: int, l: int,
               itemsize: int, *, e: int = 0, index_bytes: int = 0) -> dict:
    """``bytes`` and ``flops`` of one eMA or fused step at batch ``b``, by
    the port's roofline model (``spmm_ema_hbm_bytes``, ``spmm_ema_flops``):
    the tables read and written once, plus ``index_bytes`` of split tables
    and adjacency index. A fused step has the SpMM's ``e`` edges; an eMA
    alone is the step without its SpMM (``e`` 0), reading its ``y_p`` as a
    fused step reads ``m_p``. A shared-passive group is one step of
    ``c_p`` with ``c_a = s = 0`` plus each consumer's with ``c_p = 0``."""
    from repro_torch.analysis.roofline import (spmm_ema_flops,
                                               spmm_ema_hbm_bytes)
    return dict(bytes=spmm_ema_hbm_bytes(b, n, c_a, c_p, s, index_bytes,
                                         itemsize, fused=True),
                flops=spmm_ema_flops(b, e, n, c_p, s, l))


def _group_cost(b: int, n: int, c_p: int, consumers, itemsize: int, e: int,
                adj_bytes: int, split_bytes) -> dict:
    """``bytes`` and ``flops`` of one shared-passive group launch: its
    passive leg's SpMM over ``e`` edges once, then each consumer's
    ``(c_a, s, l)`` eMA (:func:`_step_cost`)."""
    costs = [_step_cost(b, n, 0, c_p, 0, 0, itemsize, e=e,
                        index_bytes=adj_bytes)]
    costs += [_step_cost(b, n, c_a, 0, s, l, itemsize, index_bytes=sb)
              for (c_a, s, l), sb in zip(consumers, split_bytes)]
    return dict(bytes=sum(c["bytes"] for c in costs),
                flops=sum(c["flops"] for c in costs))


def _measured_bound(name: str, nbytes: float, flops: float,
                    ms: float) -> dict:
    """The least time at the card's measured peaks (``PEAKS``) and the
    kernel's roofline fraction at them, both from ``KernelRoofline``. A
    fraction over 1 means the byte or flop count, or the peak, is wrong:
    it raises."""
    from repro_torch.analysis.roofline import KernelRoofline
    roof = KernelRoofline(name, flops, nbytes, ms / 1e3, PEAKS["f32_flops"],
                          PEAKS["bw"])
    if roof.roof_fraction > 1.0:
        raise AssertionError(
            f"{name}: {ms} ms beats its bound at the measured peaks, "
            f"{roof.bound_seconds * 1e3} ms ({nbytes} B, {flops} FLOP; "
            f"roof_fraction {roof.roof_fraction})")
    return dict(bound_ms_measured=roof.bound_seconds * 1e3,
                roof_fraction=roof.roof_fraction)


def phase_peaks() -> None:
    """The card's peaks, measured: its memory rate, the larger of a 4 GiB
    device-to-device ``copy_`` (read and write counted) and the fastest of
    seven reads of the same 4 GiB (``sum``, row sums, ``amax``, the ``dot``
    of its halves, and f32 ``mv`` at three widths; each reads it once and
    writes next to nothing); and the f32 FMA rate (an 8192^3 f32 matmul
    with TF32 off). These time yardsticks, not kernels of the port; a
    kernel row whose time beats its bound at these rates fails
    (``_measured_bound``).

    A peak is the best the card shows, so each yardstick is timed as a
    kernel row is (``_measure``): runs queued back to back behind an
    untimed one, so that no launch gap or idle card falls inside the
    events, and the fastest of ``PEAK_BATCHES`` such means is kept. Half a
    second of copies first brings the card to its clocks under load."""
    import torch

    def best_ms(fn, reps):
        ts = []
        for _ in range(PEAK_BATCHES):
            fn()
            ts.append(_time_ms(fn, reps))
        return min(ts)

    n = 1 << 30
    gen = torch.Generator(device="cuda").manual_seed(7)
    src = torch.empty(n, dtype=torch.float32, device="cuda").random_(
        0, 4, generator=gen)
    dst = torch.empty_like(src)
    for _ in range(PEAK_WARM_COPIES):
        dst.copy_(src)
    copy_ms = best_ms(lambda: dst.copy_(src), 4)
    del dst
    torch.cuda.empty_cache()
    ones = torch.ones(1 << 16, device="cuda")
    reads = {
        "sum": lambda: src.sum(),
        "row sums": lambda: src.view(1 << 14, 1 << 16).sum(dim=1),
        "amax": lambda: src.amax(),
        "dot": lambda: torch.dot(src[:n // 2], src[n // 2:]),
    }
    for w in (256, 4096, 1 << 16):
        reads[f"mv {w} wide"] = (
            lambda w=w: torch.mv(src.view(n // w, w), ones[:w]))
    read_ms = {name: best_ms(fn, 4) for name, fn in reads.items()}
    del src, ones
    torch.cuda.empty_cache()
    assert not torch.backends.cuda.matmul.allow_tf32
    k = 8192
    a = torch.randn((k, k), generator=gen, device="cuda")
    b = torch.randn((k, k), generator=gen, device="cuda")
    mm_ms = best_ms(lambda: a @ b, 3)
    del a, b
    torch.cuda.empty_cache()
    PEAKS["copy_bw"] = 2 * n * 4 / (copy_ms / 1e3)
    PEAKS["read_bw"] = n * 4 / (min(read_ms.values()) / 1e3)
    PEAKS["bw"] = max(PEAKS["copy_bw"], PEAKS["read_bw"])
    PEAKS["f32_flops"] = 2 * k ** 3 / (mm_ms / 1e3)
    reads_txt = ", ".join(f"{name} {ms:.4f} ms ({n * 4 / ms / 1e9:.4f} TB/s)"
                          for name, ms in read_ms.items())
    print(f"[peaks] {_device_line()}: device-to-device copy of {4 * n} B "
          f"{copy_ms:.4f} ms -> {PEAKS['copy_bw'] / 1e12:.4f} TB/s (read + "
          f"write); reads of {4 * n} B: {reads_txt} -> "
          f"{PEAKS['read_bw'] / 1e12:.4f} TB/s; memory rate taken "
          f"{PEAKS['bw'] / 1e12:.4f} TB/s (data sheet "
          f"{HBM_BYTES_PER_S / 1e12:.2f}); f32 matmul {k}^3 TF32 off "
          f"{mm_ms:.3f} ms -> {PEAKS['f32_flops'] / 1e12:.3f} TFLOP/s "
          f"(data sheet {F32_FLOPS_PER_S / 1e12:.0f})", flush=True)


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
    csr = _csr(g, dev)

    def rand(shape, dt):
        return torch.randint(0, 4, shape, generator=gen, device=dev).to(dt)

    def splits(t, t_a):
        return [torch.as_tensor(a, dtype=torch.int32, device=dev)
                for a in split_tables(12, t, t_a)]

    for dt in (torch.float32, torch.bfloat16):
        prep = spmm_ops.prepare(g, dtype=dt, device=dev)
        item = dt.itemsize
        print(f"[kernel] BSR operand ({dt}): n={n} m={g.m} "
              f"blocks={prep.n_blocks} tiles={prep.n_tiles} device bytes="
              f"{prep.nbytes} (nonzero index {prep.index_bytes}; no dense "
              f"blocks, which would take {prep.n_blocks * 128 * 128 * item}) "
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
                if dt == torch.float32 else None,
                library_t=_library_transposed(csr, leaf)
                if dt == torch.float32 else None))
            # --- eMA at u12 node 6: Ca=924, Cp=12, S=792, L=7
            ia6, ip6 = splits(7, 6)
            m_a6, y_p6 = rand((b, 924, n), dt), rand((b, 12, n), dt)
            cases.append(dict(
                name="ema", shape=f"m_a=({b},924,{n}) y_p=({b},12,{n}) "
                                  f"S=792 L=7",
                kernel=lambda: ema_ops.ema(m_a6, y_p6, ia6, ip6),
                plain=lambda: ema_ops.ema_plain(m_a6, y_p6, ia6, ip6),
                **_step_cost(b, n, 924, 12, 792, 7, item,
                             index_bytes=8 * ia6.numel()),
                library=None))
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
                **_step_cost(b, n, 12, 792, 924, 6, item, e=g.m,
                             index_bytes=adj_bytes + 8 * ia5.numel()),
                library=None)
            results[(case["name"], dt, b)] = _measure(case, tol, 3)
            del case, m_a5, m_p5
            torch.cuda.empty_cache()
        del prep
        torch.cuda.empty_cache()
    return results


def _measure(case: dict, tol: float, reps: int) -> dict:
    """Run the kernel and its plain version once each, compare, then time
    them (the kernel over ``reps`` runs, the plain version over one), each
    after one untimed call, so its outputs and scratch come from the
    caching allocator as on the path and not from ``cudaMalloc``."""
    import torch
    got = case["kernel"]()
    want = case["plain"]()
    _sync()
    abs_err, rel_err = _errors(got, want)
    del got, want
    torch.cuda.empty_cache()

    def timed(fn, n):
        fn()
        return _time_ms(fn, n)

    ms = timed(case["kernel"], reps)
    plain_ms = timed(case["plain"], 1)
    lib_ms = lib_t_ms = None
    if case["library"]:                    # the warm call sets up cuSPARSE
        lib_ms = timed(case["library"], reps)
    if case.get("library_t"):
        lib_t_ms = timed(case["library_t"], reps)
    bound_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ops = case["flops"] / F32_FLOPS_PER_S * 1e3
    row = dict(max_abs_err=abs_err, max_rel_err=rel_err, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_transposed_ms=lib_t_ms,
               bound_ms=max(bound_bytes, bound_ops),
               bound_by="bytes" if bound_bytes >= bound_ops else "operations",
               bytes=case["bytes"], flops=case["flops"],
               **_measured_bound(case["name"], case["bytes"], case["flops"],
                                 ms))
    lib = f"{lib_ms:.3f}" if lib_ms is not None else "n/a"
    lib_t = f" library_transposed_ms={lib_t_ms:.3f}" \
        if lib_t_ms is not None else ""
    print(f"[kernel] {case['name']:<15} {case['shape']:<48} "
          f"max_rel_err={rel_err:.3e} (tol {tol:g}) "
          f"max_abs_err={abs_err:.3e} kernel_ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={row['bound_ms']:.3f} "
          f"({row['bound_by']}) bound_ms_measured="
          f"{row['bound_ms_measured']:.3f} roof_fraction="
          f"{row['roof_fraction']:.3f} library_ms={lib}{lib_t}", flush=True)
    if not rel_err <= tol:
        raise AssertionError(f"{case['name']} disagrees with its plain "
                             f"version: {rel_err} > {tol}")
    return row


def _csr(g, dev):
    """The adjacency as a torch CSR tensor of ones (the library yardstick
    of the SpMMs; A is symmetric, so (M @ A)^T = A @ M^T)."""
    import torch
    return torch.sparse_csr_tensor(
        torch.as_tensor(g.indptr, device=dev),
        torch.as_tensor(g.indices.astype("int64"), device=dev),
        torch.ones(g.m, device=dev), size=(g.n, g.n), check_invariants=True)


def _library_transposed(csr, m):
    """``torch.sparse.mm`` on a colour-major table with the transposes in
    and out inside the call: the kernels take and give ``(rows, n)``, the
    library ``(n, rows)``."""
    import torch
    n = m.shape[-1]
    return lambda: torch.sparse.mm(
        csr, m.reshape(-1, n).t().contiguous().float()).t().contiguous()


def phase_group_kernel(g, batch: int, n_cons: int) -> dict:
    """The shared-passive group kernel against its plain version at a
    fixed shape: ``n_cons`` census roots (k=10: c_a = c_p = C(10,5) = 252,
    S = 1, L = 252) sharing one passive table, at path A's batch. With
    path A's largest group (3) this is the shape the kernel's row has been
    timed at since it was ported; the census itself does not launch it
    (its c_p = 252 group has 2 consumers, its 3-consumer groups c_p = 210).
    The census's own group shapes are timed by ``phase_shape_sweep``."""
    import torch

    from repro_torch.core.colorsets import split_tables
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda")
    n, c = g.n, math.comb(10, 5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ia, ip = (torch.as_tensor(a, dtype=torch.int32, device=dev)
              for a in split_tables(10, 10, 5))
    s, l = ia.shape
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        prep = spmm_ops.prepare(g, dtype=dt, device=dev)
        tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
        m_p = torch.randint(0, 4, (batch, c, n), generator=gen,
                            device=dev).to(dt)
        m_as = [torch.randint(0, 4, (batch, c, n), generator=gen,
                              device=dev).to(dt) for _ in range(n_cons)]
        ias, ips = [ia] * n_cons, [ip] * n_cons
        case = dict(
            name="fused_spmm_ema_shared",
            shape=f"{n_cons}x m_a=({batch},{c},{n}) m_p=({batch},{c},{n}) "
                  f"S={s} L={l}",
            kernel=lambda: fused_ops.fused_spmm_ema_shared(
                m_as, m_p, ias, ips, prep),
            plain=lambda: fused_ops.fused_spmm_ema_shared_plain(
                m_as, m_p, ias, ips, prep),
            **_group_cost(batch, n, c, [(c, s, l)] * n_cons, dt.itemsize,
                          g.m, 4 * (n + 1 + g.m), [8 * ia.numel()] * n_cons),
            library=None)
        results[dt] = _measure(case, tol, 3)
        del case, m_p, m_as, prep
        torch.cuda.empty_cache()
    return results


def phase_bsr_census_kernel(g, batch: int, c_p: int) -> None:
    """The BSR SpMM against its plain version at path A's most expensive
    unfused SpMM: the passive table of ``c_p`` colour sets at path A's
    batch, timed beside ``torch.sparse.mm``."""
    import torch

    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda")
    n = g.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    csr = _csr(g, dev)
    for dt in (torch.float32, torch.bfloat16):
        prep = spmm_ops.prepare(g, dtype=dt, device=dev)
        tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
        m = torch.randint(0, 4, (batch, c_p, n), generator=gen,
                          device=dev).to(dt)
        f32 = dt == torch.float32
        m_t = m.reshape(-1, n).t().contiguous() if f32 else None
        case = dict(
            name="spmm_bsr", shape=f"m=({batch},{c_p},{n}) census",
            kernel=lambda: spmm_ops.spmm(m, prep),
            plain=lambda: spmm_ops.spmm_plain(m, prep),
            bytes=2 * m.numel() * dt.itemsize + 4 * (n + 1 + g.m),
            flops=2 * g.m * batch * c_p,
            library=(lambda: torch.sparse.mm(csr, m_t)) if f32 else None,
            library_t=_library_transposed(csr, m) if f32 else None)
        _measure(case, tol, 3)
        del case, m, m_t, prep
        torch.cuda.empty_cache()


def phase_gather_kernel(g, batch: int) -> dict:
    """The gather SpMM against its plain version on ``rmat(20)`` at path
    B's shapes: its batch of leaf tables (12 rows a coloring) and of node
    3's passive table (220 rows), timed beside ``torch.sparse.mm``."""
    import torch

    from repro_torch.kernels.spmm import ops as spmm_ops

    dev = torch.device("cuda")
    n = g.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    prep = spmm_ops.prepare(g, "gather", device=dev)
    csr = _csr(g, dev)
    print(f"[kernel] gather operand: n={n} m={g.m} bytes={prep.nbytes} "
          f"hub_degree={prep.hub_degree} hubs={prep.n_hubs} "
          f"hub segments={prep.n_segments} max degree="
          f"{int(g.degrees.max())} scratch bytes per call: f32 "
          f"{prep.scratch_bytes(torch.float32)}, bf16 "
          f"{prep.scratch_bytes(torch.bfloat16)}", flush=True)
    results = {}
    for dt, rows in ((torch.float32, 12), (torch.bfloat16, 12),
                     (torch.float32, 220)):
        tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
        m = torch.randint(0, 4, (batch, rows, n), generator=gen,
                          device=dev).to(dt)
        f32 = dt == torch.float32
        m_t = m.reshape(-1, n).t().contiguous() if f32 else None
        case = dict(
            name="spmm_gather", shape=f"m=({batch},{rows},{n}) E={g.m}",
            kernel=lambda: spmm_ops.spmm(m, prep),
            plain=lambda: spmm_ops.spmm_gather_plain(m, prep),
            # the adjacency as int32 CSR, as the BSR rows count it
            bytes=2 * m.numel() * dt.itemsize + 4 * (n + 1 + g.m),
            flops=g.m * batch * rows,          # one add per edge and row
            library=(lambda: torch.sparse.mm(csr, m_t)) if f32 else None,
            library_t=_library_transposed(csr, m) if f32 else None)
        results[(dt, rows)] = _measure(case, tol, 3)
        del case, m, m_t
        torch.cuda.empty_cache()
    return results


def phase_chunk_kernel(g) -> dict:
    """The chunk-accumulate kernel against its plain version at u13 node
    5's chunking: c_a = 13, C(13, 7) = 1,716 passive rows in single-row
    chunks (6 pairs a chunk), S = 1,287, L = 8, batch 1, in f32 and bf16;
    and in f32 at 4-row chunks (429), where an output row takes several
    pairs of one chunk. The neighbour sums are a random (1, 1716, n) table
    sliced as the chunked eMA slices it, so a case is one coloring's
    accumulate launches without their SpMMs. The bound counts what each
    launch must move: its touched output rows read and written, its
    distinct m_a and y_c rows read once, its pair index."""
    import numpy as np
    import torch

    from repro_torch.core.colorsets import split_tables
    from repro_torch.kernels.ema import ops as ema_ops

    dev = torch.device("cuda")
    n = g.n
    k, t, t_a = 13, 8, 1
    c_a, c_p = math.comb(k, t_a), math.comb(k, t - t_a)
    ia, ip = split_tables(k, t, t_a)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    results = {}
    for dt, q in ((torch.float32, c_p), (torch.bfloat16, c_p),
                  (torch.float32, c_p // 4)):
        pack = ema_ops.pack_chunked_splits(ia, ip, c_p, q)
        walk = ema_ops.chunk_walk(pack, dev)
        r, s_ = pack.chunk_rows, pack.n_out_rows
        m_a = torch.randint(0, 4, (1, c_a, n), generator=gen,
                            device=dev).to(dt)
        y = torch.randint(0, 4, (1, c_p, n), generator=gen,
                          device=dev).to(dt)
        outs = [torch.zeros((1, s_, n), dtype=dt, device=dev)
                for _ in range(2)]

        def run(fn, out):
            for qq in range(q):
                fn(out, m_a, y[:, qq * r:(qq + 1) * r], walk, qq)
            return out

        pair_a, pair_p = walk.pair_a.cpu().numpy(), walk.pair_p.cpu().numpy()
        rows_moved = 0
        for qq in range(q):
            e0, e1 = walk.entry_ptr[qq], walk.entry_ptr[qq + 1]
            p0, p1 = walk.pair_ptr[e0], walk.pair_ptr[e1]
            rows_moved += (2 * (e1 - e0) + len(np.unique(pair_a[p0:p1]))
                           + len(np.unique(pair_p[p0:p1])))
        n_pairs = int(walk.pair_ptr[-1])
        per_entry = int(np.diff(walk.pair_ptr).max())
        case = dict(
            name="ema_chunk_acc",
            shape=f"m_a=(1,{c_a},{n}) y_c=(1,{r},{n}) x{q} chunks S={s_} "
                  f"pairs={n_pairs} (<= {per_entry} an output row a chunk)",
            kernel=lambda: run(ema_ops.ema_chunk_acc, outs[0]),
            plain=lambda: run(ema_ops.ema_chunk_acc_plain, outs[1]),
            bytes=rows_moved * n * dt.itemsize
            + 4 * (2 * walk.rows.numel() + 2 * n_pairs),
            flops=2 * n_pairs * n, library=None)
        tol = F32_RTOL if dt == torch.float32 else BF16_RTOL
        row = _measure(case, tol, 3)
        row.update(shape=case["shape"], chunks=q)
        results[(dt, q)] = row
        del case, outs, m_a, y, walk
        torch.cuda.empty_cache()
    return results


def phase_chunked_full(g, chunk_row: dict) -> tuple[dict, float]:
    """u13 on grid_2d(1024, 1024) at a 16 GiB budget through the user's
    entry point, 4 colorings: node 5 runs chunked (1,716 single-row
    chunks), node 7 fused. Then the same colorings unchunked (24 GiB,
    batch 1). Returns the chunked run's launches and estimate."""
    import torch

    from repro_torch import api

    def run(budget):
        _reset_counts()
        t0 = time.perf_counter()
        q = api.compile_query(g, api.CountQuery(
            templates="u13", max_iters=4, round_size=4, plan="optimized",
            seed=0, memory_budget_bytes=budget, batch_size=1))
        built = time.perf_counter() - t0
        res = q.run()[0]
        _sync()
        return (q.engine, res, built, _read_counts(),
                torch.cuda.max_memory_allocated())

    eng, res, built, launches, peak = run(16 * GIB)
    chunks = eng.schedule.chunk_map
    model = eng.peak_table_bytes
    operand = eng._spmm_prep.nbytes
    secs = res.seconds / res.iterations
    adj = 4 * (g.n + 1 + g.m)
    spmm_bound = chunks.get(5, 0) * (adj + 2 * g.n * 4) / HBM_BYTES_PER_S
    print(f"[full] u13 chunked on grid_2d(1024,1024) at 16 GiB: chunk_map="
          f"{chunks} fused={eng.schedule.fused} batch={eng.batch_size} "
          f"fits={eng.exec_choice.fits} estimate={res.estimate!r} "
          f"iterations={res.iterations} s_per_coloring={secs:.4f} (count "
          f"loop {res.seconds:.3f} s, engine build {built:.3f} s) "
          f"launches={launches} max_memory_allocated={peak} ({peak / GIB:.2f}"
          f" GiB) modeled tables={model} ({model / GIB:.2f} GiB) + operand "
          f"{operand}", flush=True)
    print(f"[full]   node 5 a coloring at the bound: chunk-accumulate "
          f"{chunk_row['bound_ms']:.3f} ms (measured alone "
          f"{chunk_row['ms']:.3f}), 1,716 one-row SpMMs "
          f"{spmm_bound * 1e3:.3f} ms", flush=True)
    if chunks != {5: 1716} or not eng.exec_choice.fits:
        raise AssertionError(f"u13 at 16 GiB chunked as {chunks}")
    if not (math.isfinite(res.estimate) and res.estimate > 0
            and res.iterations == 4):
        raise AssertionError(f"bad estimate {res}")
    path = ("ema_chunk_acc", "spmm_bsr", "fused_spmm_ema", "ema")
    if min(launches[k] for k in path) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if peak > model + operand:
        raise AssertionError(f"chunked peak {peak} exceeds the modeled "
                             f"tables {model} plus the operand {operand}")
    est, m_chunked = res.estimate, eng.exec_choice.peak_bytes_per_coloring
    del eng, res
    torch.cuda.empty_cache()
    eng2, res2, built2, launches2, peak2 = run(24 * GIB)
    model2 = eng2.peak_table_bytes
    print(f"[full] u13 unchunked on grid_2d(1024,1024) at 24 GiB: chunk_map="
          f"{eng2.schedule.chunk_map} batch={eng2.batch_size} estimate="
          f"{res2.estimate!r} s_per_coloring="
          f"{res2.seconds / res2.iterations:.4f} (engine build "
          f"{built2:.3f} s) launches={launches2} max_memory_allocated="
          f"{peak2} ({peak2 / GIB:.2f} GiB) modeled tables={model2} "
          f"({model2 / GIB:.2f} GiB)", flush=True)
    print(f"[full]   peaks, unchunked - chunked: measured {peak2 - peak} "
          f"({(peak2 - peak) / GIB:.2f} GiB), model "
          f"{eng2.exec_choice.peak_bytes_per_coloring - m_chunked} "
          f"({(eng2.exec_choice.peak_bytes_per_coloring - m_chunked) / GIB:.2f}"
          f" GiB); seconds per coloring chunked / unchunked "
          f"{secs / (res2.seconds / res2.iterations):.2f}", flush=True)
    if eng2.schedule.chunk_map or eng2.batch_size != 1:
        raise AssertionError("the 24 GiB engine chunked or batched")
    if not math.isclose(est, res2.estimate, rel_tol=PATH_RTOL):
        raise AssertionError(f"chunked estimate {est} != unchunked "
                             f"{res2.estimate}")
    del eng2, res2
    torch.cuda.empty_cache()
    return launches, est


def phase_parity_rowmajor() -> None:
    """FASCIA and PFASCIA, u12 on grid_2d(64, 64), 2 colorings: card
    against CPU."""
    import torch

    from repro_torch.core.engines import CountingEngine
    from repro_torch.graph.coloring import batch_colorings
    from repro_torch.graph.generators import grid_2d

    g = grid_2d(64, 64)
    cols = batch_colorings(0, range(2), g.n, 12, device="cuda")
    for engine in ("fascia", "pfascia"):
        card = CountingEngine(g, "u12", engine=engine, device="cuda")
        host = CountingEngine(g, "u12", engine=engine, device="cpu")
        t_card, r_card = card.count_colorful_batch(cols)
        t_host, r_host = host.count_colorful_batch(cols.cpu())
        _sync()
        torch.testing.assert_close(t_card.cpu(), t_host, rtol=PATH_RTOL,
                                   atol=0)
        torch.testing.assert_close(r_card.cpu(), r_host, rtol=PATH_RTOL,
                                   atol=0)
        print(f"[parity] {engine} u12 grid_2d(64,64) 2 colorings: card "
              f"totals {t_card.tolist()} == CPU totals (rtol "
              f"{PATH_RTOL:g}); root tables {tuple(r_card.shape)} agree",
              flush=True)


def phase_parity_backends() -> None:
    """The segment, ell and dense SpMM backends (torch's ops) against the
    BSR kernel on rmat(12), a (2, 220, n) integer table, f32; each run
    twice and held bit-equal to itself."""
    import torch

    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.spmm import ops as spmm_ops

    g = rmat(12)
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = torch.randint(0, 4, (2, 220, g.n), generator=gen, device="cuda",
                      dtype=torch.int32).float()
    want = spmm_ops.spmm(m, spmm_ops.prepare(g, "bsr"))
    for method in ("segment", "ell", "dense"):
        prep = spmm_ops.prepare(g, method)
        got = spmm_ops.spmm(m, prep)
        again = spmm_ops.spmm(m, prep)
        _sync()
        abs_err, rel_err = _errors(got, want)
        ms = _time_ms(lambda: spmm_ops.spmm(m, prep), 3)
        print(f"[parity] SpMM backend {method} rmat(12) n={g.n} m={g.m} "
              f"max_degree={g.max_degree} (2,220,n) f32: max abs err vs "
              f"bsr {abs_err:.3e} rel {rel_err:.3e} (rtol {F32_RTOL:g}); "
              f"repeat bit-equal {bool(torch.equal(got, again))}; "
              f"{ms:.3f} ms", flush=True)
        if rel_err > F32_RTOL or not torch.equal(got, again):
            raise AssertionError(f"SpMM backend {method} disagrees with bsr "
                                 f"or with itself")


def phase_runner(g) -> dict:
    """(R) The fault-tolerant runner on the card: u12 on grid_2d(1024,
    1024), optimized plan, 32 GiB (batch 4), 8 iterations in checkpoints
    of 3. A straight run against one cut after 4 iterations and resumed by
    a new runner, the straight run at batch 1 and 4, an injected dispatch
    fault and a torn ledger: every per-iteration sum equal bit for bit.
    Then the engine's totals over a table whose sums pass 2^24, at B =
    1..8. Returns the straight run's launches."""
    import tempfile

    import torch

    from repro_torch.core.engines import CountingEngine
    from repro_torch.core.runner import EstimatorRunner, engine_counter
    from repro_torch.graph.coloring import batch_colorings
    from repro_torch.resilience import faults

    eng = CountingEngine(g, "u12", plan="optimized",
                         memory_budget_bytes=32 * GIB)
    tpl = eng.template
    eng.estimate(4)                     # first batch: the allocator's
    _sync()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ledger_") as tmp:
        def runner(sub, batch_size=None, every=3):
            return EstimatorRunner(
                engine_counter(eng, seed=0, batch_size=batch_size), k=12,
                automorphisms=tpl.automorphisms, n_iterations=8,
                ledger_dir=str(Path(tmp) / sub), checkpoint_every=every,
                seed=0)

        def check(label, res, want):
            same = (res.per_iteration == want.per_iteration
                    and res.count == want.count)
            print(f"[runner] {label}: count={res.count!r} restarts="
                  f"{res.restarts} per-iteration sums bit-equal to the "
                  f"straight run: {same}", flush=True)
            if not same:
                raise AssertionError(f"{label}: {res.per_iteration} != "
                                     f"{want.per_iteration}")

        _reset_counts()
        t0 = time.perf_counter()
        straight = runner("straight").run()
        _sync()
        t_runner = time.perf_counter() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        est = eng.estimate(8)
        _sync()
        t_est = time.perf_counter() - t0
        t0 = time.perf_counter()
        like = runner("every4", every=4).run()
        _sync()
        t_like = time.perf_counter() - t0
        print(f"[runner] u12 grid_2d(1024,1024) batch {eng.batch_size}, 8 "
              f"iterations: straight run in checkpoints of 3 (batches "
              f"3, 3, 2) {t_runner / 8:.4f} s per coloring; in "
              f"checkpoints of 4 (batches 4, 4) {t_like / 8:.4f}; "
              f"eng.estimate(8) (batches 4, 4) {t_est / 8:.4f}; count "
              f"{straight.count!r}, estimate {est['count']!r}; launches "
              f"{launches}; max_memory_allocated={peak} ({peak / GIB:.2f} "
              f"GiB), modeled tables {eng.peak_table_bytes}", flush=True)
        if list(straight.per_iteration) != list(range(8)) or not (
                math.isfinite(straight.count) and straight.count > 0):
            raise AssertionError(f"bad straight run {straight}")
        check("checkpoints of 4", like, straight)
        if not math.isclose(straight.count, est["count"], rel_tol=1e-12):
            raise AssertionError(f"runner {straight.count} != estimate "
                                 f"{est['count']}")
        if min(launches[k] for k in ("spmm_bsr", "ema",
                                     "fused_spmm_ema")) == 0:
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{launches}")
        cut = runner("cut").run(max_iterations_this_call=4)
        if cut.completed != [0, 1, 2, 3]:
            raise AssertionError(f"cut run completed {cut.completed}")
        check("cut after 4 (batches 3, 1), resumed by a new runner "
              "(batches 3, 1)", runner("cut").run(), straight)
        check("batch 1", runner("b1", batch_size=1, every=8).run(),
              straight)
        check("batch 4", runner("b4", batch_size=4, every=8).run(),
              straight)
        # the reference's reduction, an f32 sum of each root table over
        # the whole batch, against the same sum at batch 1
        cols = batch_colorings(0, range(4), g.n, 12, device="cuda")
        _, r4 = eng.count_colorful_batch(cols, batch_size=4)
        _, r1 = eng.count_colorful_batch(cols, batch_size=1)
        f32_4 = r4.sum(dim=(-2, -1))
        f32_1 = torch.cat([r1[i:i + 1].sum(dim=(-2, -1)) for i in range(4)])
        roots_equal = bool(torch.equal(r4, r1))
        print(f"[runner] root tables at batch 4 == batch 1 bit for bit: "
              f"{roots_equal}; an f32 sum over (4,1,n) vs four (1,1,n) "
              f"sums bit-equal: {bool(torch.equal(f32_4, f32_1))} "
              f"({f32_4.tolist()} vs {f32_1.tolist()}; largest "
              f"{f32_4.max().item() / 2 ** 24:.3f} x 2^24); the engine's "
              f"float64 totals {eng._totals(r4).tolist()}", flush=True)
        if not roots_equal:
            raise AssertionError("a kernel's summation order changes with "
                                 "the batch")
        # f32 sums over integer tables of the root's shape whose sums pass
        # 2^24 (as path B's do): torch's split of the reduction changes
        # with the batch, so the engine sums each coloring in float64
        gen = torch.Generator(device="cuda").manual_seed(1)
        big = torch.randint(0, 1 << 12, (8, 1, g.n), generator=gen,
                            device="cuda").float()
        f32_rows, f64_rows = [], []
        for b in range(1, 9):
            parts = [big[i:i + b] for i in range(0, 8, b)]
            f32_rows.append(torch.cat([p.sum(dim=(-2, -1)) for p in parts]))
            f64_rows.append(torch.cat([eng._totals(p) for p in parts]))
        f32_moved = [int((r != f32_rows[0]).sum().item()) for r in f32_rows]
        f64_moved = [int((r != f64_rows[0]).sum().item()) for r in f64_rows]
        mean = big.double().sum(dim=(-2, -1)).mean().item()
        print(f"[runner] integer (8,1,n) table, sums ~{mean:.3e} "
              f"({mean / 2 ** 24:.0f} x 2^24), summed at batch B = 1..8: "
              f"rows whose f32 sum differs from batch 1 {f32_moved}; "
              f"rows whose engine total (float64) differs {f64_moved}",
              flush=True)
        if any(f64_moved):
            raise AssertionError("the engine's totals depend on the batch")
        del r4, r1, big
        plan = faults.FaultPlan([faults.FaultSpec("kernel.dispatch",
                                                  after=1, times=1)])
        with faults.active_plan(plan):
            try:
                runner("chaos").run()
            except faults.InjectedFault as exc:
                print(f"[runner] kernel.dispatch:raise after 1 hit: "
                      f"{exc}", flush=True)
            else:
                raise AssertionError("the injected dispatch fault did not "
                                     "reach the caller")
        r = runner("chaos")
        kept = sorted(r.completed_iterations())
        if kept != [0, 1, 2]:
            raise AssertionError(f"ledger after the fault holds {kept}")
        check(f"resumed after the fault (ledger held {kept})", r.run(),
              straight)
        plan = faults.FaultPlan([faults.FaultSpec("ledger.write",
                                                  mode="corrupt", times=1)])
        with faults.active_plan(plan):
            runner("torn").run(max_iterations_this_call=3)
        r = runner("torn")
        loaded = r.completed_iterations()
        sidecar = Path(tmp) / "torn" / "ledger.json.corrupt"
        if loaded or not sidecar.exists():
            raise AssertionError(f"torn ledger not quarantined: {loaded}")
        res = r.run()
        if res.restarts != 0:
            raise AssertionError("a cold restart counted as a resume")
        check("ledger.write:corrupt once, quarantined to ledger.json."
              "corrupt, restarted cold", res, straight)
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_regimes(g) -> dict:
    """(F) The paper's three regimes on one card: u12 on grid_2d(1024,
    1024), plain plan, seed 0, f32 — FASCIA over 2 colorings, PFASCIA over
    4, PGBSC (default operands and fusion) over 8, each rounded up to
    whole batches of its engine and timed after one untimed batch (the
    first batch's allocations are set-up). Iterations 0-1 agree across
    the three. Returns each regime's launches by path name."""
    import torch

    from repro_torch.core.engines import CountingEngine

    regimes = (("fascia", 2, FASCIA_BUDGET), ("pfascia", 4, PFASCIA_BUDGET),
               ("pgbsc", 8, 32 * GIB))
    sums, secs, out = {}, {}, {}
    for engine, n_want, budget in regimes:
        _reset_counts()
        t0 = time.perf_counter()
        eng = CountingEngine(g, "u12", engine=engine, plan="plain",
                             memory_budget_bytes=budget)
        _sync()
        built = time.perf_counter() - t0
        b = eng.batch_size
        n_col = -(-n_want // b) * b
        eng.count_iterations_batch(range(b), seed=0)
        _sync()
        t0 = time.perf_counter()
        per = eng.count_iterations_batch(range(n_col), seed=0)
        _sync()
        loop = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        w = eng.work
        sums[engine], secs[engine] = per, loop / n_col
        out[f"u12_plain_{engine}"] = _read_counts()
        print(f"[regime] {engine} u12 plain grid_2d(1024,1024): budget "
              f"{budget / GIB:.0f} GiB batch={eng.batch_size} fits="
              f"{eng.exec_choice.fits} {n_col} colorings after one warm "
              f"batch s_per_coloring={loop / n_col:.4f} (count loop "
              f"{loop:.3f} s, engine build {built:.3f} s) "
              f"max_memory_allocated={peak} ({peak / GIB:.2f} GiB) "
              f"modeled tables "
              f"exec_choice.peak_bytes={eng.exec_choice.peak_bytes} "
              f"({eng.exec_choice.peak_bytes / GIB:.2f} GiB) work: "
              f"total_flops={w.total_flops} (sweep/SpMM {w.spmm_flops}, "
              f"combine {w.ema_flops}) launches={out[f'u12_plain_{engine}']}"
              f" sums {[per[i] for i in range(2)]}", flush=True)
        if not all(math.isfinite(v) and v > 0 for v in per.values()):
            raise AssertionError(f"{engine}: bad sums {per}")
        del eng
        torch.cuda.empty_cache()
    for engine in ("fascia", "pfascia"):
        for i in range(2):
            if not math.isclose(sums[engine][i], sums["pgbsc"][i],
                                rel_tol=PATH_RTOL):
                raise AssertionError(
                    f"iteration {i}: {engine} {sums[engine][i]} != pgbsc "
                    f"{sums['pgbsc'][i]}")
    print(f"[regime] iterations 0-1 agree across the three (rtol "
          f"{PATH_RTOL:g}); seconds per coloring FASCIA/PGBSC "
          f"{secs['fascia'] / secs['pgbsc']:.1f}x, PFASCIA/PGBSC "
          f"{secs['pfascia'] / secs['pgbsc']:.1f}x, FASCIA/PFASCIA "
          f"{secs['fascia'] / secs['pfascia']:.1f}x", flush=True)
    # the plain plan's passive children each have one consumer: every
    # internal node runs the fused kernel
    if out["u12_plain_pgbsc"]["fused_spmm_ema"] == 0:
        raise AssertionError(f"the fused kernel never launched on the pgbsc "
                             f"path: {out['u12_plain_pgbsc']}")
    return out


def phase_reorder_mesh(g) -> dict:
    """u12 on the mesh relabelled by a seeded random permutation, 8
    colorings: (a) through the gather SpMM as it is; (b) the same with
    reorder="rcm"; (c) api.count's default BSR and fused path with
    reorder="rcm" (unreordered, its dense blocks would not fit the card).
    Returns the launches of (a), (b), (c)."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core.engines import CountingEngine
    from repro_torch.graph.reorder import apply_order
    from repro_torch.obs import metrics

    t0 = time.perf_counter()
    gs = apply_order(g, np.random.default_rng(3).permutation(g.n))
    relabel_s = time.perf_counter() - t0
    before = gs.bsr_block_stats()
    print(f"[reorder] scrambled grid_2d(1024,1024): relabelled in "
          f"{relabel_s:.2f} s; occupied 128x128 blocks "
          f"{before['occupied_blocks']} ({before['nnz_per_block']:.2f} "
          f"nonzeros a block; dense f32 blocks would take "
          f"{before['occupied_blocks'] * 128 * 128 * 4} bytes)", flush=True)
    kw = dict(plan="optimized", spmm_method="gather", fuse_spmm_ema=False,
              memory_budget_bytes=CENSUS_BUDGET)
    out, estimates = {}, {}
    reg = metrics.set_registry(metrics.MetricsRegistry())
    for label, reorder in (("a", None), ("b", "rcm")):
        t0 = time.perf_counter()
        eng = CountingEngine(gs, "u12", reorder=reorder, **kw)
        built = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        est = eng.estimate(8)
        _sync()
        secs = time.perf_counter() - t0
        out[label] = _read_counts()
        estimates[label] = est["count"]
        print(f"[full] scrambled mesh ({label}) u12 gather reorder={reorder}:"
              f" count={est['count']!r} batch={eng.batch_size} "
              f"s_per_coloring={secs / 8:.4f} (engine build {built:.3f} s, "
              f"host reorder {eng.reorder_seconds}) launches={out[label]} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()}",
              flush=True)
        if not out[label]["spmm_gather"] or not out[label]["ema"] \
                or out[label]["spmm_bsr"]:
            raise AssertionError(f"({label})'s launches are off: "
                                 f"{out[label]}")
        del eng
        torch.cuda.empty_cache()
    _reset_counts()
    t0 = time.perf_counter()
    q = api.compile_query(gs, api.CountQuery(
        templates="u12", max_iters=8, plan="optimized", seed=0,
        memory_budget_bytes=32 * GIB, reorder="rcm"))
    built = time.perf_counter() - t0
    res = q.run()[0]
    _sync()
    out["c"] = _read_counts()
    estimates["c"] = res.estimate
    gauges = reg.snapshot()["gauges"]
    after = gauges['reorder_bsr_occupied_blocks{reorder="rcm",stage="after"}']
    metrics.set_registry(metrics.MetricsRegistry())
    print(f"[full] scrambled mesh (c) api.count u12 reorder='rcm' BSR+fused:"
          f" estimate={res.estimate!r} batch={q.engine.batch_size} "
          f"s_per_coloring={res.seconds / res.iterations:.4f} (engine build "
          f"{built:.3f} s, host reorder {q.engine.reorder_seconds}) "
          f"launches={out['c']} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    print(f"[reorder]   occupied blocks {before['occupied_blocks']} -> "
          f"{int(after)} after rcm; estimates {estimates}", flush=True)
    for label in ("b", "c"):
        if not math.isclose(estimates[label], estimates["a"],
                            rel_tol=PATH_RTOL):
            raise AssertionError(f"scrambled mesh estimates disagree: "
                                 f"{estimates}")
    if min(out["c"][k] for k in ("spmm_bsr", "ema", "fused_spmm_ema")) == 0:
        raise AssertionError(f"(c)'s launches are off: {out['c']}")
    del q
    torch.cuda.empty_cache()
    return out


def phase_degree_rmat(g, est_b: float) -> dict:
    """Path B with reorder="degree": the same engine, estimate and
    colorings, the graph relabelled by descending degree. Times the gather
    SpMM at the leaf (the path's batch of 12-row tables) on both operands.
    Returns the launches."""
    import torch

    from repro_torch.core.engines import CountingEngine
    from repro_torch.graph.coloring import batch_colorings
    from repro_torch.kernels.spmm import ops as spmm_ops

    t0 = time.perf_counter()
    eng = CountingEngine(g, "u12", plan="optimized", spmm_method="gather",
                         fuse_spmm_ema=False,
                         memory_budget_bytes=CENSUS_BUDGET, reorder="degree")
    built = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    est = eng.estimate(8)
    _sync()
    secs = time.perf_counter() - t0
    launches = _read_counts()
    b = eng.batch_size
    cols = batch_colorings(0, range(b), g.n, 12, device="cuda")
    leaf = (torch.arange(12, device="cuda")[:, None]
            == cols[:, None, :]).to(torch.float32)
    times = {}
    for label, prep in (("degree", eng._spmm_prep),
                        ("as is", spmm_ops.prepare(g, "gather"))):
        spmm_ops.spmm(leaf, prep)
        times[label] = _time_ms(lambda: spmm_ops.spmm(leaf, prep), 5)
    print(f"[full] u12 gather on rmat(20) reorder='degree': count="
          f"{est['count']!r} batch={b} s_per_coloring={secs / 8:.4f} (engine "
          f"build {built:.3f} s, host reorder {eng.reorder_seconds}) "
          f"launches={launches} max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()}; gather SpMM at the leaf "
          f"({b},12,{g.n}) ms: {times}", flush=True)
    if not math.isclose(est["count"], est_b, rel_tol=PATH_RTOL):
        raise AssertionError(f"degree-reordered path B {est['count']} != "
                             f"path B {est_b}")
    if not launches["spmm_gather"] or not launches["ema"]:
        raise AssertionError(f"launches are off: {launches}")
    del eng, leaf
    torch.cuda.empty_cache()
    return launches


def kernel_shapes(eng) -> dict:
    """The eMA, fused and group launches one batch of an engine makes, by
    shape: every non-leaf node outside a shared-passive group launches an
    eMA or a fused kernel once a batch, keyed by its ``(t, t_a)``; every
    group launches the group kernel once, keyed by its members' ``(t,
    t_a)`` in member order."""
    import collections
    sch, nodes = eng.schedule, eng.plan.nodes
    out = {"ema": collections.Counter(),
           "fused_spmm_ema": collections.Counter(),
           "fused_spmm_ema_shared": collections.Counter()}
    for idx, node in enumerate(nodes):
        if node.is_leaf or idx in sch.group_of:
            continue
        kind = "fused_spmm_ema" if idx in sch.fused_set else "ema"
        out[kind][(node.size, nodes[node.active].size)] += 1
    for grp in sch.fused_groups:
        out["fused_spmm_ema_shared"][tuple(
            (nodes[m].size, nodes[nodes[m].active].size) for m in grp)] += 1
    return out


def phase_shape_sweep(label: str, g, k: int, batch: int,
                      shapes: dict) -> dict:
    """Every eMA, fused and shared-passive group shape a path launches,
    at its batch, f32: the kernel's time (one untimed call, then the mean
    of two), its bound and launches x (time - bound) a batch. The costliest
    shape of each kernel (launches x time) is then held against its plain
    version (``_measure``). Returns ``{kernel: row}`` for those, with their
    shape and launches a batch."""
    import torch

    from repro_torch.core.colorsets import split_tables
    from repro_torch.kernels.ema import ops as ema_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev, dt, n = torch.device("cuda"), torch.float32, g.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    prep = spmm_ops.prepare(g, dtype=dt, device=dev) \
        if shapes["fused_spmm_ema"] or shapes["fused_spmm_ema_shared"] \
        else None

    def rand(rows):
        return torch.empty((batch, rows, n), dtype=dt, device=dev).random_(
            0, 4, generator=gen)

    def group_case(members):
        # members share one passive child: t - t_a is the same for all
        c_p = math.comb(k, members[0][0] - members[0][1])
        m_p = rand(c_p)
        m_as, ias, ips, dims = [], [], [], []
        for t, t_a in members:
            ia, ip = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                      for a in split_tables(k, t, t_a))
            m_as.append(rand(math.comb(k, t_a)))
            ias.append(ia)
            ips.append(ip)
            dims.append((math.comb(k, t_a), *ia.shape))
        shape = (f"{len(members)}x m_p=({batch},{c_p},{n}) (c_a,S,L)="
                 f"{','.join(f'({a},{s_},{l_})' for a, s_, l_ in dims)} "
                 f"{label}")
        return dict(
            name="fused_spmm_ema_shared", shape=shape,
            **_group_cost(batch, n, c_p, dims, dt.itemsize, g.m,
                          4 * (n + 1 + g.m), [8 * ia.numel() for ia in ias]),
            kernel=lambda: fused_ops.fused_spmm_ema_shared(
                m_as, m_p, ias, ips, prep),
            plain=lambda: fused_ops.fused_spmm_ema_shared_plain(
                m_as, m_p, ias, ips, prep),
            library=None)

    def case_of(name, *key):
        if name == "fused_spmm_ema_shared":
            return group_case(key)
        t, t_a = key
        c_a, c_p = math.comb(k, t_a), math.comb(k, t - t_a)
        s_, l_ = math.comb(k, t), math.comb(t, t_a)
        ia, ip = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in split_tables(k, t, t_a))
        m_a, m_p = rand(c_a), rand(c_p)
        shape = (f"m_a=({batch},{c_a},{n}) m_p=({batch},{c_p},{n}) "
                 f"S={s_} L={l_} {label}")
        if name == "ema":
            return dict(name=name, shape=shape,
                        **_step_cost(batch, n, c_a, c_p, s_, l_, dt.itemsize,
                                     index_bytes=8 * ia.numel()),
                        kernel=lambda: ema_ops.ema(m_a, m_p, ia, ip),
                        plain=lambda: ema_ops.ema_plain(m_a, m_p, ia, ip),
                        library=None)
        return dict(name=name, shape=shape,
                    **_step_cost(batch, n, c_a, c_p, s_, l_, dt.itemsize,
                                 e=g.m, index_bytes=8 * ia.numel()
                                 + 4 * (n + 1 + g.m)),
                    kernel=lambda: fused_ops.fused_spmm_ema(m_a, m_p, ia, ip,
                                                            prep),
                    plain=lambda: fused_ops.fused_spmm_ema_plain(
                        m_a, m_p, ia, ip, prep),
                    library=None)

    costliest = {}
    for name, counts in shapes.items():
        rows = []
        for key, count in sorted(counts.items()):
            case = case_of(name, *key)
            case["kernel"]()
            ms = _time_ms(case["kernel"], 2)
            bound = max(case["bytes"] / HBM_BYTES_PER_S,
                        case["flops"] / F32_FLOPS_PER_S) * 1e3
            print(f"[sweep] {name:<21} {case['shape']:<62} x{count:<3} a "
                  f"batch: kernel_ms={ms:.3f} bound_ms={bound:.3f} "
                  f"launches_x_gap_ms={count * (ms - bound):.3f}", flush=True)
            rows.append((count * ms, key, count))
            del case
            torch.cuda.empty_cache()
        if not rows:
            continue
        print(f"[sweep] {name} {label}: {sum(c for *_, c in rows)} launches "
              f"a batch, {sum(r[0] for r in rows):.3f} ms a batch by these "
              f"times", flush=True)
        _, key, count = max(rows)
        case = case_of(name, *key)
        row = _measure(case, F32_RTOL, 3)
        row.update(shape=case["shape"], launches_per_batch=count)
        costliest[name] = row
        del case
        torch.cuda.empty_cache()
    del prep
    torch.cuda.empty_cache()
    return costliest


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


def census_specs(k: int) -> list:
    from repro_torch.core.templates import TemplateSpec
    trees = census_trees(k)
    expected = {8: 23, 10: 106}.get(k)
    if expected is not None and len(trees) != expected:
        raise AssertionError(f"census of k={k}: {len(trees)} trees, OEIS "
                             f"A000055 has {expected}")
    return [TemplateSpec(edges=e, root=r, name=f"tree{k}_{i}")
            for i, (e, r) in enumerate(trees)]


def phase_parity_census() -> None:
    """The k=8 census on grid_2d(64, 64): count_many and motif_features,
    card against CPU."""
    import numpy as np

    from repro_torch import api
    from repro_torch.graph.generators import grid_2d

    g = grid_2d(64, 64)
    specs = census_specs(8)
    kw = dict(plan="dedup", max_iters=8, seed=0)
    card = api.count_many(g, specs, device="cuda", **kw)
    host = api.count_many(g, specs, device="cpu", **kw)
    got = np.array([r.estimate for r in card])
    want = np.array([r.estimate for r in host])
    np.testing.assert_allclose(got, want, rtol=PATH_RTOL, atol=0)
    f_card = api.motif_features(g, specs, n_iters=4, device="cuda")
    f_host = api.motif_features(g, specs, n_iters=4, device="cpu")
    np.testing.assert_allclose(f_card, f_host, rtol=PATH_RTOL, atol=0)
    print(f"[parity] k=8 census ({len(specs)} trees) grid_2d(64,64): "
          f"count_many card == CPU on every estimate (rtol {PATH_RTOL:g}), "
          f"{int((got > 0).sum())} nonzero; motif_features "
          f"{f_card.shape} card == CPU", flush=True)


def phase_parity_census10() -> None:
    """All 106 estimates of the k=10 census on grid_2d(64, 64), 2
    colorings: card against CPU."""
    import numpy as np

    from repro_torch import api
    from repro_torch.graph.generators import grid_2d

    g = grid_2d(64, 64)
    specs = census_specs(10)
    kw = dict(plan="dedup", max_iters=2, round_size=2, seed=0)
    got = np.array([r.estimate for r in api.count_many(
        g, specs, device="cuda", **kw)])
    want = np.array([r.estimate for r in api.count_many(
        g, specs, device="cpu", **kw)])
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    print(f"[parity] k=10 census ({len(specs)} trees) grid_2d(64,64), 2 "
          f"colorings: largest relative error card vs CPU "
          f"{rel[want != 0].max() if (want != 0).any() else 0.0:.3e} "
          f"(rtol {PATH_RTOL:g}); {int((want > 0).sum())} nonzero, zeros "
          f"equal: {bool(np.array_equal(got == 0, want == 0))}", flush=True)
    np.testing.assert_allclose(got, want, rtol=PATH_RTOL, atol=0)


def phase_parity_gather() -> None:
    """u12 with spmm_method="gather" on rmat(12): card against CPU."""
    import torch

    from repro_torch.core.engines import CountingEngine
    from repro_torch.graph.coloring import batch_colorings
    from repro_torch.graph.generators import rmat

    g = rmat(12)
    kw = dict(plan="optimized", spmm_method="gather", fuse_spmm_ema=False)
    card = CountingEngine(g, "u12", device="cuda", **kw)
    host = CountingEngine(g, "u12", device="cpu", **kw)
    cols = batch_colorings(0, range(8), g.n, 12, device="cuda")
    t_card, r_card = card.count_colorful_batch(cols)
    t_host, r_host = host.count_colorful_batch(cols.cpu())
    _sync()
    torch.testing.assert_close(t_card.cpu(), t_host, rtol=PATH_RTOL, atol=0)
    torch.testing.assert_close(r_card.cpu(), r_host, rtol=PATH_RTOL, atol=0)
    print(f"[parity] u12 gather rmat(12) n={g.n} m={g.m} 8 colorings: card "
          f"totals == CPU totals (rtol {PATH_RTOL:g}); root tables agree",
          flush=True)


def _counters() -> dict:
    """Every kernel wrapper of the port, by kernel name; each counts its
    own launches in ``.launches``."""
    from repro_torch.kernels.ema import ops as ema_ops
    from repro_torch.kernels.fused import ops as fused_ops
    from repro_torch.kernels.spmm import ops as spmm_ops
    return {"spmm_bsr": spmm_ops.spmm, "ema": ema_ops.ema,
            "ema_chunk_acc": ema_ops.ema_chunk_acc,
            "fused_spmm_ema": fused_ops.fused_spmm_ema,
            "fused_spmm_ema_shared": fused_ops.fused_spmm_ema_shared,
            "spmm_gather": spmm_ops.spmm_gather}


def _reset_counts() -> None:
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_full(g) -> tuple[dict, object]:
    """The u12 slice at full size through the user's entry point. Returns
    the launches and the result."""
    import torch

    from repro_torch import api

    _reset_counts()
    t0 = time.perf_counter()
    res = api.count(g, "u12", max_iters=8, memory_budget_bytes=32 * GIB,
                    seed=0)
    _sync()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[full] u12 on grid_2d(1024,1024) n={g.n} m={g.m}: "
          f"estimate={res.estimate!r} stderr={res.stderr!r} "
          f"iterations={res.iterations} "
          f"s_per_coloring={res.seconds / res.iterations:.4f} "
          f"(count loop {res.seconds:.3f} s, with engine build "
          f"{wall:.3f} s) launches={launches} "
          f"max_memory_allocated={peak} ({peak / GIB:.2f} GiB; with the "
          f"dense blocks on the card: {DENSE_BLOCKS_U12_PEAK} B, "
          f"{peak - DENSE_BLOCKS_U12_PEAK:+d} B)", flush=True)
    if not (math.isfinite(res.estimate) and res.estimate > 0
            and res.iterations == 8):
        raise AssertionError(f"bad estimate {res}")
    path = ("spmm_bsr", "ema", "fused_spmm_ema")
    if min(launches[k] for k in path) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return launches, res


def phase_census_full(g) -> tuple[dict, int, int, int, dict, list]:
    """Path A: the k=10 census (106 trees) on grid_2d(1024, 1024), plan
    "dedup", 8 colorings, through ``compile_query(...).run()`` — the body
    of ``api.count_many`` — so the engine's groups and batch can be read.
    Returns (launches, batch size, largest group, colour sets of the
    largest passive table the SpMM kernel takes, eMA and fused launches a
    batch by shape, the 106 estimates)."""
    import torch

    from repro_torch import api

    specs = census_specs(10)
    _reset_counts()
    t0 = time.perf_counter()
    q = api.compile_query(g, api.CountQuery(
        templates=tuple(specs), max_iters=8, plan="dedup", seed=0,
        memory_budget_bytes=CENSUS_BUDGET))
    built = time.perf_counter() - t0
    res = q.run()
    _sync()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    eng = q.engine
    groups = eng.schedule.fused_groups
    secs = res[0].seconds
    print(f"[full] k=10 census ({len(specs)} trees) on grid_2d(1024,1024): "
          f"plan nodes={eng.plan.n_nodes} groups admitted={len(groups)} "
          f"sizes={[len(gr) for gr in groups]} fused nodes="
          f"{len(eng.schedule.fused)} batch={eng.batch_size} "
          f"iterations={res[0].iterations} s_per_coloring={secs / 8:.4f} "
          f"(count loop {secs:.3f} s, engine build {built:.3f} s, total "
          f"{wall:.3f} s) spmm_cols_per_coloring="
          f"{eng.spmm_cols_per_coloring} modeled peak="
          f"{eng.peak_table_bytes} launches={launches} "
          f"max_memory_allocated={peak} ({peak / GIB:.2f} GiB)", flush=True)
    est = [r.estimate for r in res]
    print(f"[full]   estimates: min={min(est)!r} max={max(est)!r} "
          f"zero={sum(e == 0 for e in est)}", flush=True)
    unfused = unfused_spmm_rows(eng)
    print(f"[full]   unfused SpMMs per batch by passive colour sets: "
          f"{sorted(unfused.items())}", flush=True)
    # a tree embeds in the grid exactly when no vertex has degree > 4
    for spec, r in zip(specs, res):
        deg = max(sum(v in e for e in spec.edges) for v in range(spec.k))
        if not (math.isfinite(r.estimate) and r.iterations == 8
                and (r.estimate > 0) == (deg <= 4)):
            raise AssertionError(f"bad census estimate for {spec}: {r}")
    if len(groups) < 3:
        raise AssertionError(f"only {len(groups)} shared-passive groups")
    path = ("spmm_bsr", "ema", "fused_spmm_ema", "fused_spmm_ema_shared")
    if min(launches[k] for k in path) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return (launches, eng.batch_size, max(len(gr) for gr in groups),
            max(unfused), kernel_shapes(eng), est)


def unfused_spmm_rows(eng) -> dict:
    """How many of an engine's SpMMs per batch go through the SpMM kernel
    (the passive children of nodes neither fused nor grouped, once each:
    the executor's y-cache), by the passive table's colour sets."""
    import collections
    sch, nodes = eng.schedule, eng.plan.nodes
    seen, out = set(), collections.Counter()
    for idx, node in enumerate(nodes):
        if node.is_leaf or idx in sch.fused_set or idx in sch.group_of \
                or node.passive in seen:
            continue
        seen.add(node.passive)
        out[math.comb(eng.k, nodes[node.passive].size)] += 1
    return out


def layout_sizes(g, tile: int = 128, chunk: int = 512) -> dict:
    """What the other SpMM operands would hold for ``g``: the occupied
    tile pairs, the dense f32 blocks over them, and the JAX package's
    gather layout (``Graph.edge_chunks``: each pair's edges padded to
    ``chunk``-edge chunks of int32 source, int32 local destination and an
    f32 mask, one chunk more for each empty destination tile)."""
    import numpy as np
    src, dst = g.indices, np.repeat(np.arange(g.n), g.degrees)
    n_tiles = -(-g.n // tile)
    _, per_pair = np.unique((dst // tile) * n_tiles + src // tile,
                            return_counts=True)
    empty = n_tiles - len(np.unique(dst // tile))
    chunks = int((-(-per_pair // chunk)).sum()) + empty
    return {"tile_pairs": len(per_pair),
            "dense_block_bytes": (len(per_pair) + empty) * tile * tile * 4,
            "padded_chunk_bytes": chunks * chunk * 12}


def phase_gather_full(g) -> tuple[dict, int, dict, dict]:
    """Path B: u12 on rmat(20) through the gather SpMM, 8 colorings.
    Returns (launches, batch size, eMA launches a batch by shape, the
    estimate with its samples and seconds per coloring)."""
    import torch

    from repro_torch.core.engines import CountingEngine
    from repro_torch.kernels.spmm import ops as spmm_ops

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = CountingEngine(g, "u12", plan="optimized", spmm_method="gather",
                         fuse_spmm_ema=False,
                         memory_budget_bytes=CENSUS_BUDGET)
    built = time.perf_counter() - t0
    prep = eng._spmm_prep
    if not isinstance(prep, spmm_ops.GatherPrep) \
            or eng._fused_prep is not None:
        raise AssertionError("the gather engine built a BSR operand")
    _reset_counts()
    t0 = time.perf_counter()
    est = eng.estimate(8)
    _sync()
    secs = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[full] u12 gather on rmat(20) n={g.n} m={g.m}: "
          f"count={est['count']!r} std={est['std']!r} batch="
          f"{eng.batch_size} s_per_coloring={secs / 8:.4f} (estimate "
          f"{secs:.3f} s, engine build {built:.3f} s) operand bytes="
          f"{prep.nbytes} + scratch {prep.scratch_bytes(eng.dtype)} "
          f"(hubs={prep.n_hubs} hub segments={prep.n_segments}) "
          f"modeled peak={eng.peak_table_bytes} "
          f"launches={launches} max_memory_allocated={peak} "
          f"({peak / GIB:.2f} GiB)", flush=True)
    if not (math.isfinite(est["count"]) and est["count"] > 0
            and len(est["samples"]) == 8):
        raise AssertionError(f"bad estimate {est}")
    if launches["spmm_bsr"] or launches["fused_spmm_ema"] \
            or not launches["spmm_gather"] or not launches["ema"]:
        raise AssertionError(f"path B's launches are off: {launches}")
    return (launches, eng.batch_size, kernel_shapes(eng),
            dict(est, s_per_coloring=secs / 8))


def _profile(label: str, fn, cpu: bool = True) -> None:
    """Run ``fn`` under ``torch.profiler``: the host wall time, the device's
    busy time (the union of kernel intervals) and idle share, device time
    and launches by kernel, the largest first, and where the host waits:
    its CUDA runtime calls by time and the allocator's retries (a
    ``cudaMalloc`` that failed, so every cached block was freed and the
    device synced). ``cpu=False`` records the device's activity alone: a
    run of ~10^5 launches otherwise takes minutes to parse its operator
    events."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    by_name = collections.Counter()
    launched = collections.Counter()
    host = collections.Counter()
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            launched[e.name] += 1
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("cuda"):
            host[e.name] += e.time_range.elapsed_us()
    busy, end = 0, None
    for a, b in sorted(spans):           # union of kernel intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    print(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f}",
          flush=True)
    for name, us in by_name.most_common(8):
        print(f"[profile]   {us / 1e3:10.2f} ms {launched[name]:6d}x  "
              f"{name[:100]}", flush=True)
    calls = ", ".join(f"{name} {us / 1e3:.1f} ms"
                      for name, us in host.most_common(4))
    print(f"[profile]   host CUDA calls: {calls}; allocator retries "
          f"{retries}", flush=True)


def phase_profile(g, g_rmat) -> None:
    """Where the time goes: one batch of each full-size path, its engine
    built outside the profiled window."""
    import torch

    from repro_torch import api
    from repro_torch.core.engines import CountingEngine

    q = api.CompiledQuery(g, api.CountQuery(
        templates="u12", max_iters=4, round_size=4,
        memory_budget_bytes=32 * GIB))
    _profile("u12 grid_2d(1024,1024) batch of 4", q.run)
    del q
    torch.cuda.empty_cache()
    q = api.compile_query(g, api.CountQuery(
        templates=tuple(census_specs(10)), plan="dedup",
        memory_budget_bytes=CENSUS_BUDGET, max_iters=2, round_size=2))
    _profile(f"k=10 census grid_2d(1024,1024) batch of "
             f"{q.engine.batch_size}", q.run)
    del q
    torch.cuda.empty_cache()
    eng = CountingEngine(g_rmat, "u12", plan="optimized",
                         spmm_method="gather", fuse_spmm_ema=False,
                         memory_budget_bytes=CENSUS_BUDGET)
    b = eng.batch_size
    _profile(f"u12 gather rmat(20) batch of {b}",
             lambda: eng.count_iterations_batch(range(b)))
    del eng
    torch.cuda.empty_cache()
    q = api.compile_query(g, api.CountQuery(
        templates="u13", max_iters=1, round_size=1, batch_size=1,
        memory_budget_bytes=16 * GIB))
    _profile("u13 chunked grid_2d(1024,1024) one coloring", q.run)
    del q
    torch.cuda.empty_cache()
    for engine, budget in (("fascia", FASCIA_BUDGET),
                           ("pfascia", PFASCIA_BUDGET)):
        eng = CountingEngine(g, "u12", engine=engine, plan="plain",
                             memory_budget_bytes=budget)
        b = eng.batch_size
        _profile(f"{engine} u12 plain grid_2d(1024,1024) batch of {b}",
                 lambda: eng.count_iterations_batch(range(b)))
        del eng
        torch.cuda.empty_cache()


# --------------------------------------------------------- (S) the service
SERVICE_BUDGET = 32 * GIB      # u12 at batch 4, as api.count in phase_full


def _u12_relabelled() -> str:
    """u12's edges under v -> 11 - v, in the CLI's ``"u-v,...@root"``
    form: a third spelling of the same rooted tree."""
    from repro_torch.core.templates import get_template
    t = get_template("u12")
    k = t.k
    return ",".join(f"{k - 1 - u}-{k - 1 - v}" for u, v in t.edges) + \
        f"@{k - 1 - t.root}"


def _service_counts(total: dict) -> dict:
    """Read the launches since the last reset into ``total``."""
    got = _read_counts()
    for name, c in got.items():
        total[name] = total.get(name, 0) + c
    return got


def _service_load(g, tmp: str):
    """Step 1: the mesh written as an edge list and loaded as a user loads
    one, parsed once and then read from the ``.npz`` cache."""
    from repro_torch.graph.io import load_cached, save_edge_list

    path = os.path.join(tmp, "grid_1024.txt")
    t0 = time.perf_counter()
    save_edge_list(g, path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    g1 = load_cached(path)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    g2 = load_cached(path)
    t_npz = time.perf_counter() - t0
    print(f"[service] step 1: edge list {os.path.getsize(path)} B written in "
          f"{t_save:.2f} s; load_cached parses it in {t_parse:.2f} s, the "
          f"second load reads the .npz ({os.path.getsize(path + '.cache.npz')}"
          f" B) in {t_npz:.2f} s (host); fingerprint {g2.fingerprint[:12]}",
          flush=True)
    for loaded in (g1, g2):
        if loaded.fingerprint != g.fingerprint or loaded.m != g.m:
            raise AssertionError("the loaded mesh is not the generator's")
    return path, g2


def _service_batch(path: str, tmp: str, res_u12, total: dict):
    """Step 2: batch mode through ``launch/serve.main``, in-process, held
    to ``phase_full``'s ``api.count`` result ``res_u12``."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import serve
    from repro_torch.obs import tracing
    from repro_torch.obs.validate import validate_snapshot

    metrics_out = os.path.join(tmp, "metrics.json")
    argv = ["--edge-list", path, "--templates", "u12,u12,u10",
            "--template-edges", _u12_relabelled(), "--iters", "8",
            "--round-size", "8", "--memory-budget-mb", "32768",
            "--metrics-out", metrics_out, "--trace",
            "--ledger", os.path.join(tmp, "ledger_batch")]
    tracer = tracing.set_tracer(tracing.Tracer())
    _reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
    finally:
        tracing.configure(enabled=False, sync=False)
        out = buf.getvalue()
        lines = out.splitlines()
        # serve's own lines, without the results object it prints last
        last = max((i for i, ln in enumerate(lines) if ln == "{"),
                   default=len(lines))
        for ln in lines[:last]:
            print(f"[service]   serve: {ln}", flush=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _service_counts(total)
    results = json.loads("\n".join(lines[last:]))
    svc = results.pop("_service")
    with open(metrics_out) as f:
        snap = validate_snapshot(json.load(f))
    levels = {k: v for k, v in snap["gauges"].items()
              if k.startswith("degradation_level")}
    dispatch = [c for r in tracer.roots if r.name == "service.round"
                for c in r.children if c.name == "service.dispatch"]
    u12_disp = [d for d in dispatch if d.attrs.get("tenants") == 3]
    u12 = {k: v for k, v in results.items() if not k.endswith(":u10")}
    creator = results[min(u12)]
    secs_u12 = sum(d.seconds for d in u12_disp) / 8
    print(f"[service] step 2: serve.main batch mode rc={rc} in {wall:.2f} s: "
          f"requests={list(results)} (all done) engine builds={svc['engine_cache']['builds']} groups="
          f"{svc['groups']} unique_iterations={svc['unique_iterations']}; "
          f"u12 estimate={creator['estimate']!r} (api.count "
          f"{res_u12.estimate!r}); u12 group s_per_coloring={secs_u12:.4f} "
          f"(its dispatch span, 8 colorings, ledger checkpoint included; "
          f"api.count {res_u12.seconds / res_u12.iterations:.4f}, the "
          f"process's first full-size count); cold engine build "
          f"{creator['breakdown']['compile_s']:.3f} s; launches={launches} "
          f"max_memory_allocated={peak} ({peak / GIB:.2f} GiB); "
          f"degradation_level gauges={levels}", flush=True)
    if rc != 0 or len(results) != 4:
        raise AssertionError(f"serve returned {rc} with {list(results)}")
    if svc["engine_cache"]["builds"] != 2 or svc["groups"] != 2:
        raise AssertionError(f"4 requests built {svc['engine_cache']} in "
                             f"{svc['groups']} groups")
    if len(u12) != 3 or len({v["estimate"] for v in u12.values()}) != 1 \
            or sum(v["shared_group"] for v in u12.values()) != 2:
        raise AssertionError(f"the three u12 spellings did not share: {u12}")
    if not math.isclose(creator["estimate"], res_u12.estimate,
                        rel_tol=PATH_RTOL):
        raise AssertionError(f"served u12 {creator['estimate']} != "
                             f"api.count {res_u12.estimate}")
    if not levels or any(v != 0 for v in levels.values()):
        raise AssertionError(f"degradation levels {levels}")
    if len(u12_disp) != 1:
        raise AssertionError(f"u12 dispatch spans {u12_disp}")
    if min(launches[k] for k in ("spmm_bsr", "ema", "fused_spmm_ema")) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return creator["estimate"], results[[k for k in results
                                         if k.endswith(":u10")][0]]["estimate"]


def _service_u10_reference(g, est_u10: float) -> None:
    """Step 2a: the served u10 estimate held to ``api.count``'s on the
    same graph, template, iterations, seed and budget (outside the
    service, so a fault of the service at u10's batch and shapes shows)."""
    from repro_torch import api

    t0 = time.perf_counter()
    res = api.count(g, "u10", max_iters=8, seed=0,
                    memory_budget_bytes=SERVICE_BUDGET)
    _sync()
    print(f"[service] step 2a: served u10 estimate={est_u10!r} vs api.count "
          f"{res.estimate!r} ({time.perf_counter() - t0:.2f} s, rtol "
          f"{PATH_RTOL:g})", flush=True)
    if not math.isclose(est_u10, res.estimate, rel_tol=PATH_RTOL):
        raise AssertionError(f"served u10 {est_u10} != api.count "
                             f"{res.estimate}")
    del res
    _reset_counts()


def _service_release(g) -> None:
    """Step 2b: a one-engine cache evicts (releases) the u12 and u10
    engines as two more templates come in."""
    import gc

    import torch

    from repro_torch.service import EngineCache

    gc.collect()
    torch.cuda.empty_cache()
    cache = EngineCache(max_entries=1)
    kw = dict(device="cuda", memory_budget_bytes=SERVICE_BUDGET)
    base = torch.cuda.memory_allocated()
    mem = []
    for tname in ("u12", "u10", "u5"):
        cache.get(g, tname, **kw)
        mem.append(torch.cuda.memory_allocated() - base)
    operand = mem[0]
    print(f"[service] step 2b: EngineCache(max_entries=1), u12 then u10 then "
          f"u5: memory_allocated above the start {mem} B (one operand "
          f"{operand} B); evictions={cache.evictions}; both evicted engines "
          f"released", flush=True)
    if cache.evictions != 2 or max(mem) > 1.05 * operand:
        raise AssertionError(f"evicted engines kept their operands: {mem}")
    del cache
    gc.collect()
    torch.cuda.empty_cache()


def _service_profile(g, tmp: str) -> None:
    """Step 2c: one service round of a u12 request at batch 4 (attach on
    a warm engine, one dispatch, the ledger checkpoint, retirement) under
    ``torch.profiler``, beside phase_profile's ``api.count`` batch."""
    import gc

    import torch

    from repro_torch.service import (CountingService, CountRequest,
                                     EngineCache)

    cache = EngineCache()
    svc = CountingService(ledger_root=os.path.join(tmp, "ledger_prof"),
                          round_size=4, default_max_iters=4,
                          memory_budget_bytes=SERVICE_BUDGET,
                          engine_cache=cache)
    svc.add_graph("g", g)
    cache.get(g, "u12", "pgbsc", "optimized", **svc.engine_kw)
    svc.submit(CountRequest("g", "u12", max_iters=4, seed=1))
    _profile("service round, u12 grid_2d(1024,1024) batch of 4", svc.step)
    if svc.stats()["unique_iterations"] != 4:
        raise AssertionError(f"the profiled round ran {svc.stats()}")
    del svc, cache
    gc.collect()
    torch.cuda.empty_cache()


def _http(base: str, path: str, body: dict | None = None):
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read() or b"{}")


def _service_http(g, tmp: str, est_u12: float, est_u10: float,
                  total: dict) -> None:
    """Step 3: the async QoS service behind the HTTP front end on an
    ephemeral port, prewarmed with u12."""
    import gc

    import torch

    from repro_torch.obs.validate import validate_snapshot
    from repro_torch.service import AsyncCountingService, EngineCache
    from repro_torch.service.frontend import serve_forever

    svc = AsyncCountingService(
        ledger_root=os.path.join(tmp, "ledger_http"), round_size=8,
        default_max_iters=8, memory_budget_bytes=SERVICE_BUDGET,
        engine_cache=EngineCache(), idle_wait_s=0.01)
    svc.add_graph("g", g)
    _reset_counts()
    httpd = serve_forever(svc, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        t0 = time.perf_counter()
        svc.prewarm("g", "u12")
        while not svc.engine_cache.has(g, "u12", **svc.engine_kw):
            time.sleep(0.01)
            if time.perf_counter() - t0 > 300:
                raise AssertionError("prewarm never built u12")
        t_warm = time.perf_counter() - t0
        posts = [({"templates": ["u12"], "qos": {"class": "interactive",
                                                 "tenant": "alice"}}, est_u12),
                 ({"templates": ["u12"], "qos": {"class": "interactive",
                                                 "tenant": "bob"}}, est_u12),
                 ({"templates": ["u10"], "qos": {"class": "batch",
                                                 "tenant": "etl"}}, est_u10)]
        sent = []
        for body, want in posts:
            body = dict(body, graph="g", max_iters=8, seed=0, wait=False)
            t_post = time.perf_counter()
            code, out = _http(base, "/count", body)
            if code != 202:
                raise AssertionError(f"POST /count -> {code} {out}")
            sent.append((out["requests"][0]["id"], t_post, want, body))
        walls = {}
        while len(walls) < len(sent):
            for rid, t_post, want, body in sent:
                if rid in walls:
                    continue
                code, out = _http(base, f"/result/{rid}")
                if code == 200:
                    walls[rid] = (time.perf_counter() - t_post,
                                  out["result"]["estimate"], want, body)
                elif code != 202:
                    raise AssertionError(f"/result/{rid} -> {code} {out}")
            time.sleep(0.005)
            if time.perf_counter() - t0 > 600:
                raise AssertionError("the HTTP requests never finished")
        # a repeat of a finished question: the estimate cache answers it,
        # so its round trip is the front end's own cost
        t1 = time.perf_counter()
        code, again = _http(base, "/count", {"graph": "g",
                                             "templates": ["u12"],
                                             "max_iters": 8, "seed": 0})
        t_cached = time.perf_counter() - t1
        code_h, health = _http(base, "/healthz")
        code_m, snap = _http(base, "/metrics.json")
        validate_snapshot(snap)
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    launches = _service_counts(total)
    peak = torch.cuda.max_memory_allocated()
    for rid, (wall, got, want, body) in walls.items():
        print(f"[service] step 3: {rid} {body['templates'][0]} "
              f"{body['qos']['class']}/{body['qos']['tenant']}: POST to "
              f"result {wall:.3f} s, estimate {got!r}", flush=True)
        if got != want and not math.isclose(got, want, rel_tol=PATH_RTOL):
            raise AssertionError(f"HTTP estimate {got} != batch {want}")
    print(f"[service] step 3: prewarm of u12 {t_warm:.3f} s; cached repeat "
          f"POST round trip {t_cached * 1e3:.2f} ms (from_cache="
          f"{again['requests'][0]['result']['from_cache']}); healthz "
          f"{code_h} ok={health['ok']} groups={health['groups']}; "
          f"/metrics.json valid ({len(snap['counters'])} counters); "
          f"launches={launches} max_memory_allocated={peak} "
          f"({peak / GIB:.2f} GiB); shut down cleanly", flush=True)
    if code != 200 or not again["requests"][0]["result"]["from_cache"] \
            or code_h != 200 or not health["ok"] or code_m != 200:
        raise AssertionError(f"front end: {code} {again} {code_h} {health}")
    if svc._thread is not None:
        raise AssertionError("the dispatcher did not stop")
    del svc
    gc.collect()
    torch.cuda.empty_cache()


def _service_chunk_bundle(g, tmp: str, est_u13: float, total: dict) -> None:
    """Step 4: a u13 request under a 16 GiB budget runs colorset-chunked;
    the census bundle through ``compile_query(engine_cache=)`` twice
    builds once."""
    import gc

    import torch

    from repro_torch import api
    from repro_torch.obs import metrics
    from repro_torch.service import (CountingService, CountRequest,
                                     EngineCache)

    gc.collect()
    _reset_counts()
    svc = CountingService(ledger_root=os.path.join(tmp, "ledger_u13"),
                          round_size=4, default_max_iters=4,
                          memory_budget_bytes=16 * GIB)
    svc.add_graph("g", g)
    t0 = time.perf_counter()
    rid = svc.submit(CountRequest("g", "u13", max_iters=4))
    res = svc.run()[rid]
    wall = time.perf_counter() - t0
    (grp,) = svc._groups.values()
    eng = grp.engine
    launches = _service_counts(total)
    print(f"[service] step 4: u13 at 16 GiB: chunk_map="
          f"{eng.schedule.chunk_map} batch={eng.batch_size} estimate="
          f"{res.estimate!r} (api.count {est_u13!r}) in {wall:.2f} s "
          f"({res.breakdown['execute_s'] / 4:.4f} s a coloring after the "
          f"build) launches={launches}", flush=True)
    if eng.schedule.chunk_map != {5: 1716} or launches["ema_chunk_acc"] == 0:
        raise AssertionError(f"u13 did not run chunked: "
                             f"{eng.schedule.chunk_map} {launches}")
    if not math.isclose(res.estimate, est_u13, rel_tol=PATH_RTOL):
        raise AssertionError(f"served u13 {res.estimate} != {est_u13}")
    del svc, grp, eng
    gc.collect()
    torch.cuda.empty_cache()

    cache = EngineCache()
    query = api.CountQuery(templates=tuple(census_specs(10)), plan="dedup",
                           max_iters=2, round_size=2, seed=0,
                           memory_budget_bytes=CENSUS_BUDGET)
    built = metrics.counter("engine_cache_builds_total")
    runs = []
    for _ in range(2):
        _reset_counts()
        b0 = built.value
        t0 = time.perf_counter()
        out = api.compile_query(g, query, engine_cache=cache).run()
        runs.append((time.perf_counter() - t0, built.value - b0,
                     _service_counts(total), [r.estimate for r in out]))
    for i, (secs, builds, counts, _) in enumerate(runs):
        print(f"[service] step 4: census bundle run {i + 1} through "
              f"compile_query(engine_cache=): {secs:.2f} s, engine builds "
              f"{builds}, launches={counts}", flush=True)
    if runs[0][1] != 1 or runs[1][1] != 0 or cache.builds != 1:
        raise AssertionError(f"the cached bundle rebuilt: {cache.stats()}")
    if runs[1][2]["fused_spmm_ema_shared"] == 0 or runs[0][3] != runs[1][3]:
        raise AssertionError("the cached bundle's second run differs")
    del cache
    gc.collect()
    torch.cuda.empty_cache()


def _service_fault(g, tmp: str, est_u12: float, total: dict,
                   times: int) -> None:
    """Step 5: ``times`` injected dispatch faults step a fresh u12 group's
    ladder by one rung for every two: 2 to level 1 (unfused, the BSR SpMM
    and eMA kernels), 4 to level 2 (also the gather SpMM kernel). Either
    way it still gives the estimate, on hand-written kernels only."""
    import gc

    import torch

    from repro_torch.obs import metrics
    from repro_torch.resilience import faults
    from repro_torch.resilience.retry import RetryPolicy
    from repro_torch.service import CountingService, CountRequest

    want_level, want_spmm = {2: (1, "spmm_bsr"), 4: (2, "spmm_gather")}[times]
    _reset_counts()
    svc = CountingService(
        ledger_root=os.path.join(tmp, f"ledger_fault{times}"), round_size=8,
        default_max_iters=8, memory_budget_bytes=SERVICE_BUDGET,
        degrade_after=2, retry_policy=RetryPolicy(max_attempts=times + 2,
                                                  base_delay_s=0.01))
    svc.add_graph("g", g)
    plan = faults.FaultPlan([faults.FaultSpec("kernel.dispatch",
                                              mode="raise", times=times)],
                            seed=0)
    with faults.active_plan(plan):
        rid = svc.submit(CountRequest("g", "u12", max_iters=8))
        res = svc.run()[rid]
    launches = _service_counts(total)
    (grp,) = svc._groups.values()
    ladders = svc.resilience_state()["degraded_ladders"]
    level = metrics.gauge("degradation_level", engine="pgbsc",
                          template=grp.key[1][:8]).value
    print(f"[service] step 5 ({times} faults): kernel.dispatch raised "
          f"{plan.stats()['kernel.dispatch:raise']['fired']} times; ladder "
          f"{ladders}, degradation_level gauge {level}; engine "
          f"fuse_spmm_ema={grp.engine.fuse_spmm_ema} spmm_method="
          f"{grp.engine.spmm_method}; estimate {res.estimate!r} (batch "
          f"{est_u12!r}); launches={launches}", flush=True)
    if level != want_level or grp.engine.fuse_spmm_ema is not False:
        raise AssertionError(f"the ladder did not step to level "
                             f"{want_level}: {ladders}")
    other = "spmm_gather" if want_spmm == "spmm_bsr" else "spmm_bsr"
    if launches["fused_spmm_ema"] != 0 or launches[other] != 0 \
            or launches["ema"] == 0 or launches[want_spmm] == 0:
        raise AssertionError(f"the level-{want_level} engine did not run "
                             f"{want_spmm} and ema alone: {launches}")
    if not math.isclose(res.estimate, est_u12, rel_tol=PATH_RTOL):
        raise AssertionError(f"degraded u12 {res.estimate} != {est_u12}")
    del svc, grp
    gc.collect()
    torch.cuda.empty_cache()


def phase_service(g, res_u12, est_u13: float) -> dict:
    """(S) the counting service on the card, through the port's modules
    only: graph IO, batch serve, HTTP serve, chunking and a cached bundle,
    injected failures to ladder levels 1 and 2, held to ``phase_full``'s
    u12 result and ``phase_chunked_full``'s u13 estimate. Returns the
    launches of all its steps."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    total: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        path, g_loaded = _service_load(g, tmp)
        est_served, est_u10 = _service_batch(path, tmp, res_u12, total)
        _service_u10_reference(g, est_u10)
        _service_release(g)
        _service_profile(g, tmp)
        _service_http(g_loaded, tmp, est_served, est_u10, total)
        _service_chunk_bundle(g, tmp, est_u13, total)
        for times in (2, 4):
            _service_fault(g, tmp, est_served, total, times)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[service] (S) took {time.perf_counter() - t0:.1f} s; launches "
          f"{total}", flush=True)
    if min(total[k] for k in ("spmm_bsr", "spmm_gather", "ema",
                              "fused_spmm_ema", "fused_spmm_ema_shared",
                              "ema_chunk_acc")) == 0:
        raise AssertionError(f"a kernel of (S) never launched: {total}")
    return total


DIST_ITERS = [0, 1, 2, 3]      # (D)'s iterations, seed 0


def _distributed_kernels(dpg, g) -> dict:
    """(D)'s kernels at the ring's shapes, f32, each held against its
    plain version (``_measure``): the gather SpMM on the ring's piece
    ``(my shard, block 0)`` at the leaf's and the widest passive table's
    rows, the eMA's gather form at its costliest node, its scatter form at
    every scatter node, and the widest scatter node remapped as model
    shard 0 of 2 would run it (its half of the active child, the passive
    with the zero row that the terms of shard 1 read) — a form world 1
    does not run. Returns ``{label: row}`` with each row's shape and
    launches a coloring."""
    import torch

    from repro_torch.core.distributed import local_splits, shard_plan
    from repro_torch.kernels.ema import ops as ema_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev, n = dpg.device, dpg.block
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    prep = dpg.ring_preps[0]
    e = int(prep.src.numel())
    csr = _csr(g, dev) if dpg.d_data == 1 else None

    def rand(rows):
        return torch.empty((rows, n), device=dev).random_(0, 4,
                                                          generator=gen)

    meta = dpg.meta
    # each table's rows on this rank
    rows_of = {i: m.width_pad // dpg.d_model for i, m in enumerate(meta)}
    passives = sorted({m.passive for m in meta if m.collective})
    out = {}
    for p in sorted({passives[0], max(passives, key=rows_of.get)}):
        # the leaf's and the widest passive table's SpMM
        m = rand(rows_of[p])
        m_t = m.t().contiguous() if csr is not None else None
        case = dict(
            name="spmm_gather", shape=f"m=({rows_of[p]},{n}) E={e} (ring)",
            kernel=lambda: spmm_ops.spmm_gather(m, prep),
            plain=lambda: spmm_ops.spmm_gather_plain(m, prep),
            bytes=2 * m.numel() * 4 + 4 * (n + 1 + e), flops=e * m.shape[0],
            library=(lambda: torch.sparse.mm(csr, m_t))
            if csr is not None else None,
            library_t=_library_transposed(csr, m) if csr is not None
            else None)
        row = _measure(case, F32_RTOL, 3)
        row.update(shape=case["shape"], launches_per_batch=dpg.d_data)
        out[f"spmm_gather passive {p}"] = row
        del case, m, m_t
        torch.cuda.empty_cache()
    # the gather form's widest node (output rows x terms), every scatter
    # node, and the widest scatter node as model shard 0 of 2
    gathers = [i for i, m in enumerate(meta) if m.collective == "gather"]
    scatters = [i for i, m in enumerate(meta) if m.collective == "scatter"]
    meta2 = shard_plan(dpg.plan, dpg.k, 2)
    wide = max((i for i in scatters if meta2[i].collective == "scatter"),
               key=lambda i: meta[i].ia.size)
    cases = [(max(gathers, key=lambda i: meta[i].ia.size), 1)] + [
        (i, 1) for i in scatters] + [(wide, 2)]
    for i, d_model in cases:
        m = (meta if d_model == 1 else meta2)[i]
        if d_model == 1:
            ia, ip = dpg.splits[i]
        else:
            ia, ip = (torch.as_tensor(t, device=dev) for t in local_splits(
                meta2, i, 2, 0))
        c_p = meta[m.passive].width_pad
        if m.collective == "gather":
            m_a = rand(meta[m.active].width_pad)
        else:
            m_a = rand(meta2[m.active].width_pad // d_model)
        y_p = rand(c_p)
        if d_model == 2:
            y_p = torch.cat([y_p, torch.zeros((1, n), device=dev)])
        c_a, s, l = m_a.shape[0], *ia.shape
        form = m.collective + (" remapped as shard 0 of 2"
                               if d_model == 2 else "")
        case = dict(
            name="ema", shape=f"m_a=({c_a},{n}) y_p=({y_p.shape[0]},{n}) "
                              f"S={s} L={l} node {i} {form}",
            kernel=lambda: ema_ops.ema(m_a, y_p, ia, ip),
            plain=lambda: ema_ops.ema_plain(m_a, y_p, ia, ip),
            **_step_cost(1, n, c_a, y_p.shape[0], s, l, 4,
                         index_bytes=8 * ia.numel()),
            library=None)
        row = _measure(case, F32_RTOL, 10)
        row.update(shape=case["shape"], launches_per_batch=int(d_model == 1))
        out[f"ema node {i}" + (" shard 0 of 2" if d_model == 2 else "")] = row
        del case, m_a, y_p
        torch.cuda.empty_cache()
    return out


def phase_distributed(g) -> tuple[dict, dict]:
    """(D) distributed PGBSC under NCCL at world size 1: one rank, mesh
    ``(1, 1)`` as ``("data", "model")``, ``init_process_group`` on a
    ``FileStore`` under ``TMPDIR``. ``DistributedPgbsc(g, "u12",
    plan="dedup").count_iterations(DIST_ITERS, seed=0)`` after one untimed
    iteration — the ring's gather SpMM and both eMA forms — with its
    seconds per iteration and peak beside the memory model; each sum held bit for bit against the
    single-device gather engine on the same ``coloring_for_seed``
    coloring; then the kernels at the ring's shapes. The process group is
    destroyed before it returns. Returns (launches, kernel rows)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import (DistributedPgbsc,
                                              coloring_for_seed)
    from repro_torch.core.engines import CountingEngine
    from repro_torch.core.executor import simulate_peak_rows
    from repro_torch.launch.mesh import make_mesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        dpg = DistributedPgbsc(g, "u12", make_mesh((1, 1), ("data", "model")),
                               plan="dedup")
        build_s = time.perf_counter() - t0
        # untimed: NCCL sets its communicator up at the first collective
        dpg.count_iterations(DIST_ITERS[:1], seed=0)
        _sync()
        _reset_counts()
        t0 = time.perf_counter()
        _, per = dpg.count_iterations(DIST_ITERS, seed=0)
        _sync()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        model = simulate_peak_rows(dpg.plan, dpg.k, dpg.exec_schedule) \
            * dpg.n_pad * 4 // (dpg.d_data * dpg.d_model)
        operand = sum(p.nbytes for p in dpg.ring_preps)
        transient = dpg.transient_bytes()
        print(f"[dist] u12 dedup on the mesh (n={g.n}, m={g.m}), mesh (1, 1) "
              f"(data, model) under nccl: n_pad={dpg.n_pad} block="
              f"{dpg.block} forms={dpg.collective_choice()} build "
              f"{build_s:.3f} s; {len(DIST_ITERS)} iterations in {wall:.3f} "
              f"s, s_per_iteration={wall / len(DIST_ITERS):.4f} "
              f"launches={launches} max_memory_allocated={peak} "
              f"({peak / GIB:.2f} GiB) against the model's tables {model} B "
              f"({model / GIB:.2f} GiB) + the transient (gather scratch) {transient} "
              f"B + ring operand {operand} B (peak - those "
              f"{peak - model - transient - operand:+d} B) sums={per}; "
              f"collectives at world 1: two float64 all_reduces a coloring "
              f"(no ring transfer, gather or reduce-scatter)", flush=True)
        if min(launches["spmm_gather"], launches["ema"]) == 0:
            raise AssertionError(f"(D) did not launch its kernels: "
                                 f"{launches}")
        eng = CountingEngine(g, "u12", plan="dedup", spmm_method="gather",
                             fuse_spmm_ema=False, device="cuda")
        for it in DIST_ITERS:
            colors = coloring_for_seed(it, dpg.n_pad, g.n, 12,
                                       device="cuda")[:g.n]
            want = float(eng.count_colorful(colors)[0])
            if per[it] != want:
                raise AssertionError(f"(D) iteration {it}: {per[it]!r} "
                                     f"against the gather engine's {want!r}")
        print(f"[dist] every sum equals the single-device gather engine's "
              f"on the same coloring, bit for bit", flush=True)
        eng.release()
        del eng
        torch.cuda.empty_cache()
        rows = _distributed_kernels(dpg, g)
        del dpg
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, rows


def _device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm
    call, by CUDA events, with the card held busy (``torch.cuda._sleep``)
    while the host queues the launches, so a launch shorter than its host
    overhead is timed on the card alone."""
    import torch
    fn()
    _sync()
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _tune_case(name: str, label: str, candidates, default, run_at, plain,
               nbytes: int, flops: int, tuned) -> dict:
    """Every launch shape of one kernel at one of its path's shapes: each
    candidate held against the plain version exactly (the launch shape
    changes no sum's order), timed, and printed with its bound; then the
    autotuner's own pick (``tuned()`` runs the wrapper with
    ``autotune=True``; its choice is read from the autotuner's cache)
    beside the default."""
    import torch
    want = plain()
    _sync()
    times, fractions = {}, {}
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    for c in candidates:
        got = run_at(c)
        _sync()
        abs_err, _ = _errors(got, want)
        del got
        times[c] = _device_ms(lambda: run_at(c), 5)
        roof = _measured_bound(name, nbytes, flops, times[c])
        measured = roof["bound_ms_measured"]
        fractions[str(c)] = roof["roof_fraction"]
        print(f"[tune] {name:<11} {label:<50} shape={str(c):<9} "
              f"kernel_ms={times[c]:.4f} bound_ms={bound:.4f} "
              f"bound_ms_measured={measured:.4f} roof_fraction="
              f"{roof['roof_fraction']:.3f} max_abs_err={abs_err:.1e}"
              f"{' (default)' if c == default else ''}", flush=True)
        if abs_err != 0.0:
            raise AssertionError(f"{name} at launch shape {c} differs from "
                                 f"its plain version by {abs_err}")
    del want
    torch.cuda.empty_cache()
    from repro_torch.kernels import autotune
    before = set(autotune.cache_info())
    tuned()
    _sync()
    torch.cuda.empty_cache()
    picked = [v for k, v in autotune.cache_info().items() if k not in before]
    if len(picked) != 1 or picked[0] not in times:
        raise AssertionError(f"{name} {label}: the autotuner cached {picked}")
    winner = picked[0]
    gain = times[default] - times[winner]
    print(f"[tune] {name} {label}: the autotuner picks {winner} "
          f"({times[winner]:.4f} ms) against the default {default} "
          f"({times[default]:.4f} ms): {gain:+.4f} ms a launch, "
          f"x{times[default] / times[winner]:.3f}", flush=True)
    return dict(name=name, shape=label, default=str(default),
                winner=str(winner), ms={str(c): t for c, t in times.items()},
                bound_ms=bound, bound_ms_measured=measured,
                roof_fraction=fractions)


def phase_autotune_kernels(g, g_rmat, batch_a: int, batch_b: int) -> list:
    """The three tuned kernels at the shapes their paths launch them
    with, f32: the BSR SpMM at u12's leaf (batch 4) and at the chunked
    walk's one-row chunk on the mesh; the eMA at u12's node 6 (batch 4),
    the census's costliest shapes (210,120) S=120 L=35 and (120,120)
    S=210 L=20 (path A's batch) and path B's node 6 (path B's batch); the
    gather SpMM at path B's leaf on rmat(20). Returns one row a shape."""
    import torch

    from repro_torch.core.colorsets import split_tables
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ema import ops as ema_ops
    from repro_torch.kernels.spmm import ops as spmm_ops

    dev, dt = torch.device("cuda"), torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    autotune.clear_cache()
    rows = []

    def rand(shape):
        return torch.empty(shape, dtype=dt, device=dev).random_(
            0, 4, generator=gen)

    def spmm_case(graph, label, m, prep):
        r = m.numel() // graph.n
        if isinstance(prep, spmm_ops.BsrPrep):
            name, cands, default = ("spmm_bsr", spmm_ops.bsr_shapes(
                r, autotune.SPMM_C_BLOCK_CANDIDATES),
                spmm_ops.BSR_ROWS_DEFAULT)
            plain, flops = spmm_ops.spmm_plain, 2 * graph.m * r
        else:
            name, cands, default = ("spmm_gather", spmm_ops.gather_shapes(
                prep, autotune.GATHER_BLOCK_CANDIDATES),
                spmm_ops.GATHER_DESTS_DEFAULT)
            plain, flops = spmm_ops.spmm_gather_plain, graph.m * r
        rows.append(_tune_case(
            name, label, cands, default,
            lambda c: spmm_ops.spmm(m, prep, c_block=c),
            lambda: plain(m, prep),
            2 * m.numel() * dt.itemsize + 4 * (graph.n + 1 + graph.m), flops,
            lambda: spmm_ops.spmm(m, prep, autotune=True)))

    prep = spmm_ops.prepare(g, dtype=dt, device=dev)
    spmm_case(g, "u12 leaf m=(4,12,n) mesh", rand((4, 12, g.n)), prep)
    spmm_case(g, "u13 chunk m=(1,1,n) mesh", rand((1, 1, g.n)), prep)
    del prep
    for label, b, k, t, t_a in (("u12 node 6", 4, 12, 7, 6),
                                ("census (210,120)", batch_a, 10, 7, 4),
                                ("census (120,120)", batch_a, 10, 6, 3),
                                ("path B node 6", batch_b, 12, 7, 6)):
        ia, ip = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in split_tables(k, t, t_a))
        s_, l_ = ia.shape
        m_a = rand((b, math.comb(k, t_a), g.n))
        y_p = rand((b, math.comb(k, t - t_a), g.n))
        shape = (f"{label} m_a={tuple(m_a.shape)} y_p={tuple(y_p.shape)} "
                 f"S={s_} L={l_}")
        cands = ema_ops.ema_shapes(m_a, y_p, ia)
        rows.append(_tune_case(
            "ema", shape, cands, cands[0],
            lambda c: ema_ops.ema(m_a, y_p, ia, ip, s_block=c[0],
                                  n_block=c[1]),
            lambda: ema_ops.ema_plain(m_a, y_p, ia, ip),
            *_step_cost(b, g.n, m_a.shape[1], y_p.shape[1], s_, l_,
                        dt.itemsize, index_bytes=8 * ia.numel()).values(),
            lambda: ema_ops.ema(m_a, y_p, ia, ip, autotune=True)))
        del m_a, y_p
        torch.cuda.empty_cache()
    prep = spmm_ops.prepare(g_rmat, "gather", device=dev)
    spmm_case(g_rmat, f"path B leaf m=({batch_b},12,n) rmat(20)",
              rand((batch_b, 12, g_rmat.n)), prep)
    del prep
    torch.cuda.empty_cache()
    print(f"[tune] sweep launches (apart from the paths' counts): spmm "
          f"{spmm_ops.spmm.sweep_launches}, ema "
          f"{ema_ops.ema.sweep_launches}, spmm_gather "
          f"{spmm_ops.spmm_gather.sweep_launches}", flush=True)
    return rows


def _autotune_counters() -> dict:
    from repro_torch.obs import metrics
    return {k: v for k, v in metrics.get_registry().snapshot()[
        "counters"].items() if k.startswith("autotune_cache_")}


def phase_autotune_full(g, est_u12: float, est_census: list,
                        est_u13: float) -> dict:
    """u12 on the mesh, the k=10 census and u13 chunked at 16 GiB with
    ``autotune_blocks=True`` (``engine_kw``): each after a warm run of one
    batch that sweeps every shape (its ``autotune.sweep`` spans timed
    apart, outside the timed loops), then untuned, tuned, tuned, untuned
    (one fresh engine each, the sweeps' winners cached): every estimate
    bit-equal to the untuned paths' earlier runs, the seconds per coloring
    of both, and the autotuner's cache counters. Returns the first tuned
    run's launches by path."""
    import statistics

    import torch

    from repro_torch import api
    from repro_torch.kernels import autotune
    from repro_torch.obs import tracing

    specs = census_specs(10)
    autotune.clear_cache()

    def query(templates, iters, budget, tuned=True, **kw):
        return api.compile_query(g, api.CountQuery(
            templates=templates, max_iters=iters, round_size=iters,
            plan=kw.pop("plan", "optimized"), seed=0,
            memory_budget_bytes=budget, **kw),
            engine_kw={"autotune_blocks": tuned})

    cases = (
        ("u12", 32 * GIB, lambda it, tu: query("u12", it, 32 * GIB, tu), 4,
         8, [est_u12]),
        ("census", CENSUS_BUDGET, lambda it, tu: query(
            tuple(specs), it, CENSUS_BUDGET, tu, plan="dedup"), 2, 8,
         est_census),
        ("u13 chunked", 16 * GIB, lambda it, tu: query(
            "u13", it, 16 * GIB, tu, batch_size=1), 1, 4, [est_u13]))
    out = {}
    for label, budget, make, warm_iters, iters, want in cases:
        prev = tracing.set_tracer(tracing.Tracer(enabled=True))
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            make(warm_iters, True).run()
            _sync()
            warm = time.perf_counter() - t0
            warm_peak = torch.cuda.max_memory_allocated()
            sweep = tracing.get_tracer().breakdown().get(
                "autotune.sweep", {"count": 0, "seconds": 0.0})
        finally:
            tracing.set_tracer(prev)
        if sweep["count"] == 0:
            raise AssertionError(f"the warm {label} run swept nothing")
        secs = {False: [], True: []}
        peaks = {}
        for tuned in (False, True, True, False):
            torch.cuda.empty_cache()
            _reset_counts()
            q = make(iters, tuned)
            res = q.run()
            _sync()
            peaks.setdefault(tuned, torch.cuda.max_memory_allocated())
            if tuned and label not in out:
                out[label] = _read_counts()
                batch, chunks = (q.engines[0].batch_size,
                                 q.engines[0].schedule.chunk_map)
            if [r.estimate for r in res] != want:
                raise AssertionError(f"{label} (autotune_blocks={tuned}) "
                                     f"estimates differ from the untuned "
                                     f"path's")
            secs[tuned].append(res[0].seconds / iters)
            del q, res
        plain, tuned_s = (statistics.mean(secs[False]),
                          statistics.mean(secs[True]))
        print(f"[autotune] {label} with autotune_blocks=True: warm run "
              f"{warm:.3f} s holding {sweep['count']} sweeps of "
              f"{sweep['seconds']:.3f} s; s_per_coloring untuned, tuned, "
              f"tuned, untuned: {secs[False][0]:.4f} {secs[True][0]:.4f} "
              f"{secs[True][1]:.4f} {secs[False][1]:.4f} (tuned / untuned "
              f"{tuned_s / plain:.3f}); estimates bit-equal to the untuned "
              f"path's ({want[0]!r}{' ...' if len(want) > 1 else ''}); "
              f"batch={batch} chunk_map={chunks} launches={out[label]}; "
              f"max_memory_allocated: warm (sweeping) run {warm_peak}, "
              f"untuned {peaks[False]}, tuned {peaks[True]} (budget "
              f"{budget}; sweeping - untuned {warm_peak - peaks[False]})",
              flush=True)
        torch.cuda.empty_cache()
    winners = {}
    for key, choice in autotune.cache_info().items():
        winners.setdefault(key[0], []).append((key[1], choice))
    for kind, picks in winners.items():
        print(f"[autotune] winners, {kind}: {picks}", flush=True)
    print(f"[autotune] counters: {_autotune_counters()}", flush=True)
    return out


def phase_rmat_defaults(g, est_b: dict, batch_b: int) -> dict:
    """u12 on rmat(20) on the port's defaults: the BSR operand (its
    nonzero index alone: no dense block on the card) and fusion, f32, 48
    GiB, through ``compile_query(...).run()`` (``api.count``), one full
    batch of path B's size (``batch_b`` colorings, path B's batch), so its
    tables are those every caller with ``max_iters >= batch_b`` holds. Its
    estimate is held against path B's gather engine on the same colorings
    (its first ``batch_b`` samples). Returns the launches."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.kernels.spmm import ops as spmm_ops

    torch.cuda.empty_cache()
    _reset_counts()
    t0 = time.perf_counter()
    q = api.compile_query(g, api.CountQuery(
        templates="u12", max_iters=batch_b, round_size=batch_b,
        plan="optimized", seed=0, memory_budget_bytes=CENSUS_BUDGET))
    built = time.perf_counter() - t0
    eng = q.engine
    prep = eng._spmm_prep
    if not isinstance(prep, spmm_ops.BsrPrep) or eng._fused_prep is not prep:
        raise AssertionError("the default engine did not build the BSR "
                             "operand for both its SpMM and fused kernels")
    if not eng.exec_choice.fits:
        raise AssertionError(
            f"u12 on rmat(20) does not fit {CENSUS_BUDGET} B on the BSR "
            f"walk: one coloring's tables model "
            f"{eng.exec_choice.peak_bytes_per_coloring} B")
    print(f"[full] u12 rmat(20) on the defaults: BSR operand "
          f"{prep.nbytes} B on the card (col_ptr "
          f"{prep.col_ptr.numel() * 4} B, nz_src {prep.nnz} B; blocks="
          f"{prep.n_blocks}, dense blocks would take "
          f"{prep.n_blocks * 128 * 128 * 4} B) built in {built:.1f} s; fused "
          f"nodes {eng.schedule.fused} batch={eng.batch_size}", flush=True)
    try:
        res = q.run()[0]
        _sync()
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"u12 on rmat(20) on the BSR walk did not fit the card: operand "
            f"{prep.nbytes} B, modeled tables {eng.peak_table_bytes} B at "
            f"batch {eng.batch_size}") from e
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = float(np.mean(est_b["samples"][:batch_b]))
    secs = res.seconds / res.iterations
    print(f"[full] u12 rmat(20) on the defaults: estimate={res.estimate!r} "
          f"(path B's gather engine on the same {batch_b} colorings "
          f"{want!r}, rel "
          f"{abs(res.estimate - want) / want:.2e}, rtol {PATH_RTOL:g}) "
          f"s_per_coloring={secs:.4f} (path B {est_b['s_per_coloring']:.4f}) "
          f"launches={launches} max_memory_allocated={peak} "
          f"({peak / GIB:.2f} GiB; modeled tables {eng.peak_table_bytes} + "
          f"operand {prep.nbytes}) at batch {eng.batch_size}", flush=True)
    if eng.batch_size != batch_b:
        raise AssertionError(f"the default engine's batch is "
                             f"{eng.batch_size}, path B's {batch_b}")
    if not (res.iterations == batch_b and math.isclose(res.estimate, want,
                                                 rel_tol=PATH_RTOL)):
        raise AssertionError(f"rmat(20) default estimate {res.estimate} != "
                             f"path B's {want}")
    if peak > CENSUS_BUDGET + prep.nbytes:
        raise AssertionError(f"rmat(20) peak {peak} over the budget plus "
                             f"the operand")
    if not (launches["spmm_bsr"] and launches["fused_spmm_ema"]) \
            or launches["spmm_gather"]:
        raise AssertionError(f"the default path's launches are off: "
                             f"{launches}")
    del q, eng, prep, res
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ (G) the GNNs on the card
GNN_OPT = dict(lr=1e-2, warmup_steps=5, total_steps=200, weight_decay=0.0)
MOTIFS = ["u3", "path4", "star4"]
# (arch id, edge_attr): every GNN kind of the registry at reduced_config
GNN_PARITY = (("graphsage-reddit", False), ("pna", False),
              ("gatedgcn", False), ("gatedgcn", True), ("nequip", False))


def _close_to_largest(label: str, got, want, rtol: float,
                      atol: float = 1e-6) -> float:
    """Card against CPU: every element within ``atol + rtol * max|want|``
    (``index_add_`` and ``scatter_reduce`` add with atomics on the card,
    so their order changes from run to run). -> the largest error."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    err = (got - want).abs().max().item() if want.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    if not err <= atol + rtol * scale:
        raise AssertionError(f"{label}: card against CPU {err!r} over "
                             f"{atol} + {rtol} * {scale!r}")
    return err


def _gnn_fns(kind: str):
    """(forward, loss) of a model kind."""
    from repro_torch.models import equivariant, gnn
    if kind == "nequip":
        return equivariant.nequip_forward, equivariant.nequip_energy_loss
    return gnn.gnn_forward, gnn.gnn_loss


def _build_model(cfg, d_in: int, device):
    """The kind's model drawn on the CPU from generator seed 0, then moved
    to ``device``: the card's and the CPU's start from one set."""
    import torch

    from repro_torch.models.equivariant import build_nequip
    from repro_torch.models.gnn import build_gnn
    gen = torch.Generator().manual_seed(0)
    model = build_nequip(cfg, device="cpu", generator=gen) \
        if cfg.kind == "nequip" else build_gnn(cfg, d_in, device="cpu",
                                               generator=gen)
    return model.to(device)


def phase_gnn_parity() -> None:
    """(G0): every GNN kind at ``reduced_config``, card against CPU from
    one set of parameters: the forward, the loss, every gradient (and
    NequIP's forces), then the loss after 5 AdamW steps."""
    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import gnn_batch
    from repro_torch.models.equivariant import nequip_forces
    from repro_torch.optim.optimizer import AdamW, AdamWConfig

    for arch_id, edge_attr in GNN_PARITY:
        arch = reduced_config(arch_id)
        kind = arch.model.kind
        cell = "smoke_molecule" if kind == "nequip" else "smoke_full"
        forward, loss_fn = _gnn_fns(kind)
        runs = {}
        for dev in ("cpu", "cuda"):
            batch = gnn_batch(arch, cell, 3, device=dev)
            d_in = 0 if kind == "nequip" else batch["x"].shape[1]
            if edge_attr:        # narrower than d_in: the model pads it
                e = batch["edge_index"].shape[1]
                batch["edge_attr"] = torch.as_tensor(
                    np.random.default_rng(5).normal(size=(e, d_in - 2))
                    .astype(np.float32), device=dev)
            model = _build_model(arch.model, d_in, dev)
            out = forward(model, batch)
            loss = loss_fn(model, batch)
            loss.backward()
            grads = [p.grad for p in model.parameters()]
            forces = nequip_forces(model, batch)[1] if kind == "nequip" \
                else None
            opt = AdamW(model.named_parameters(), AdamWConfig(**GNN_OPT))
            for _ in range(5):
                opt.zero_grad(set_to_none=True)
                loss_fn(model, batch).backward()
                opt.step()
            after = loss_fn(model, batch).item()
            runs[dev] = (out, loss.item(), grads, forces, after)
        (out_c, l_c, g_c, f_c, a_c), (out_g, l_g, g_g, f_g, a_g) = \
            runs["cpu"], runs["cuda"]
        label = arch_id + (" edge_attr" if edge_attr else "")
        err = _close_to_largest(f"{label} forward", out_g, out_c, 1e-5)
        _close_to_largest(f"{label} loss", torch.tensor(l_g),
                          torch.tensor(l_c), 1e-5)
        g_err = 0.0
        for i, (a, b) in enumerate(zip(g_g, g_c)):
            if (a is None) != (b is None):
                raise AssertionError(f"{label}: gradient {i} on one side")
            if b is not None:
                g_err = max(g_err, _close_to_largest(
                    f"{label} gradient {i}", a, b, 1e-5))
        if f_c is not None:
            _close_to_largest(f"{label} forces", f_g, f_c, 1e-5)
        if not abs(a_g - a_c) <= 1e-4 * abs(a_c):
            raise AssertionError(f"{label}: loss after 5 AdamW steps "
                                 f"{a_g!r} on the card, {a_c!r} on the CPU")
        print(f"[gnn parity] {label} {cell}: forward max err {err:.3e}, "
              f"gradients {g_err:.3e}, loss {l_g!r} (CPU {l_c!r}), after 5 "
              f"AdamW steps {a_g!r} (CPU {a_c!r})", flush=True)


def _example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_gnn_example() -> None:
    """(G1): ``examples/gnn_motif_features_torch.main`` on the card and on
    the CPU: equal motif features, final losses within ``rtol 1e-3``."""
    import numpy as np
    ex = _example("gnn_motif_features_torch")
    runs = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        runs[dev] = ex.main(device=dev)
        print(f"[gnn example] {dev}: {time.perf_counter() - t0:.2f} s",
              flush=True)
    cpu, card = runs["cpu"], runs["cuda"]
    if not np.array_equal(card["features"], cpu["features"]):
        raise AssertionError("the example's motif features differ between "
                             "the card and the CPU")
    for key in ("random", "motif"):
        lc, lg = cpu[key]["losses"][-1], card[key]["losses"][-1]
        print(f"[gnn example] {key}: final_loss {lg!r} held-out accuracy "
              f"{card[key]['accuracy']} on the card; {lc!r} and "
              f"{cpu[key]['accuracy']} on the CPU", flush=True)
        if not abs(lg - lc) <= 1e-3 * abs(lc):
            raise AssertionError(f"example {key}: final loss {lg!r} on the "
                                 f"card, {lc!r} on the CPU")


def _train_steps(label: str, model, batch, loss_fn, steps: int, *,
                 forces=False):
    """One untimed AdamW step, ``steps`` timed, and one under
    ``torch.profiler``. -> (losses, seconds a timed step, peak bytes over
    all of them)."""
    import torch

    from repro_torch.models.equivariant import nequip_forces
    from repro_torch.optim.optimizer import AdamW, AdamWConfig
    opt = AdamW(model.named_parameters(), AdamWConfig(**GNN_OPT))
    losses = []

    def step():
        opt.zero_grad(set_to_none=True)
        if forces:           # forces on the same graph as the loss
            energy, f = nequip_forces(model, batch)
            loss = torch.mean((energy - batch["labels"]) ** 2)
            if not torch.isfinite(f).all():
                raise AssertionError("non-finite forces")
        else:
            loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())

    torch.cuda.reset_peak_memory_stats()
    step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    _sync()
    sec = (time.perf_counter() - t0) / steps
    _profile(f"{label}, one AdamW step", step)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    return losses, sec, torch.cuda.max_memory_allocated()


def _gnn_line(arch_id, cell, batch, model, losses, sec, peak, extra=""):
    e = batch["edge_index"].shape[1]
    n = batch["positions" if "positions" in batch else "x"].shape[0]
    params = sum(p.numel() for p in model.parameters())
    print(f"[gnn] {arch_id} {cell}: n={n} e={e} params={params} "
          f"s_per_step={sec!r} max_memory_allocated={peak} "
          f"({peak / GIB:.2f} GiB){extra} losses={losses}", flush=True)


def sage_peak_bytes(n: int, e: int, d_feat: int, d: int = 128) -> int:
    """The analytic peak of a full-batch GraphSAGE step (f32, 2 layers),
    reached in the backward of the second layer's mean: its ``(E, d)``
    message gradient beside the four ``(N, d)`` activations autograd still
    holds for the embedding and the first layer (the embedding's ReLU
    output, the first mean, ReLU output and normalized output), the two
    ``(N, d)`` gradients in flight, and the batch (features, int32 edges,
    labels, mask, graph ids)."""
    f = 4
    return e * d * f + 6 * n * d * f + n * d_feat * f + 2 * e * 4 + 3 * n * 4


def phase_gnn_full(g) -> tuple[dict, dict]:
    """(G2): ``motif_features`` of u3, path4 and star4 on the mesh through
    the card's kernels, held equal to the CPU port's; GraphSAGE at
    graphsage-reddit's registered width trained on them with 20 AdamW
    steps; graphsage-reddit at ``ogb_products``; pna and gatedgcn at
    ``minibatch_lg``; nequip at ``molecule`` (forces by autograd).
    Returns the kernels' launches over the motif features and the mesh's
    training, and the motif engines' shape sweeps (``phase_shape_sweep``)
    by label."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.core.engines import CountingEngine
    from repro_torch.core.templates import TemplateSpec
    from repro_torch.data.synthetic import gnn_batch
    from repro_torch.models.gnn import gnn_loss

    _reset_counts()
    t0 = time.perf_counter()
    feats = api.motif_features(g, MOTIFS, n_iters=8, seed=0)
    _sync()
    motif_s = time.perf_counter() - t0
    launched = _read_counts()
    if feats.shape != (g.n, 3) or not np.isfinite(feats).all():
        raise AssertionError(f"bad motif features {feats.shape}")
    bsr_side = ("spmm_bsr", "ema", "fused_spmm_ema", "fused_spmm_ema_shared")
    if sum(launched[k] for k in bsr_side) == 0 or any(
            v for k, v in launched.items() if k not in bsr_side):
        raise AssertionError(f"motif features launched {launched}")
    t0 = time.perf_counter()
    feats_cpu = api.motif_features(g, MOTIFS, n_iters=8, seed=0,
                                   device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(feats, feats_cpu):
        raise AssertionError(
            f"motif features on the mesh: {int((feats != feats_cpu).sum())} "
            f"entries differ from the CPU's, max |diff| "
            f"{float(np.abs(feats - feats_cpu).max())!r}")
    print(f"[gnn] motif_features({MOTIFS}) on grid_2d(1024,1024), 8 "
          f"colorings: {motif_s:.3f} s with the engine builds, launches "
          f"{launched}, column means {feats.mean(0).tolist()}; equal to "
          f"the CPU port's exactly (CPU {cpu_s:.1f} s)", flush=True)

    arch = get_config("graphsage-reddit")
    cfg = arch.model
    rng = np.random.default_rng(0)
    base = rng.normal(size=(g.n, 8)).astype(np.float32)
    # a random linear teacher on the random columns: labels to be learnt
    labels = (base @ rng.normal(size=(8, cfg.n_classes))).argmax(1)
    src, dst = g.edges_by_dst
    dev = torch.device("cuda")
    batch = {"x": torch.as_tensor(np.concatenate([base, feats], 1),
                                  device=dev),
             "edge_index": torch.as_tensor(np.stack([src, dst]).astype(
                 np.int32), device=dev),
             "labels": torch.as_tensor(labels.astype(np.int32), device=dev),
             "node_graph": torch.zeros(g.n, dtype=torch.int32, device=dev),
             "pool": False, "n_graphs": 1}
    model = _build_model(cfg, 11, dev)
    # 20 AdamW steps: one untimed, 18 timed, one profiled
    losses, sec, peak = _train_steps("graphsage-reddit on the mesh", model,
                                     batch, gnn_loss, 18)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mesh GraphSAGE did not learn: {losses}")
    _gnn_line("graphsage-reddit", "grid_2d(1024,1024) + motif features",
              batch, model, losses, sec, peak)
    counts = _read_counts()
    del batch, model
    torch.cuda.empty_cache()
    # each kernel at the shapes the motif engines launch, against its
    # plain version: one engine a template size, one batch of 8 colorings
    specs = [TemplateSpec.of(t) for t in MOTIFS]
    sweeps = {}
    for k in sorted({s.k for s in specs}):
        trees = [s.tree for s in specs if s.k == k]
        eng = CountingEngine(g, trees if len(trees) > 1 else trees[0],
                             engine="pgbsc", plan="dedup", device=dev)
        sweeps[f"gnn_motif_mesh k={k}"] = phase_shape_sweep(
            f"motif k={k}", g, k, min(eng.batch_size, 8), kernel_shapes(eng))
        del eng
        torch.cuda.empty_cache()

    for arch_id, cell, seed in (("graphsage-reddit", "ogb_products", 0),
                                ("pna", "minibatch_lg", 1),
                                ("gatedgcn", "minibatch_lg", 2),
                                ("nequip", "molecule", 3)):
        arch = get_config(arch_id)
        t0 = time.perf_counter()
        batch = gnn_batch(arch, cell, seed, device="cuda")
        _sync()
        made = time.perf_counter() - t0
        kind = arch.model.kind
        d_in = 0 if kind == "nequip" else batch["x"].shape[1]
        model = _build_model(arch.model, d_in, dev)
        losses, sec, peak = _train_steps(f"{arch_id} {cell}", model, batch,
                                         _gnn_fns(kind)[1], 3,
                                         forces=kind == "nequip")
        extra = f" batch_made_s={made:.2f}"
        if arch_id == "graphsage-reddit":
            want = sage_peak_bytes(batch["x"].shape[0],
                                   batch["edge_index"].shape[1],
                                   batch["x"].shape[1])
            extra += f" analytic_peak={want} ({peak - want:+d} B)"
        _gnn_line(arch_id, cell, batch, model, losses, sec, peak, extra)
        del batch, model
        torch.cuda.empty_cache()
    return counts, sweeps


# ----------------------------------- (L) the LM and AutoInt models on the card
LM_IDS = ("smollm-360m", "llama3-8b", "gemma3-1b", "deepseek-moe-16b",
          "qwen3-moe-30b-a3b")
# L3's serving shape: batch, prompt, prefill chunk (the reference's
# default), decode steps; the cache holds the prompt and the steps
LM_SERVE = dict(batch=8, prompt=2048, chunk=1024, steps=32)
# L1: (label, arch id, layer stack, window flag, tokens a row); gemma3's
# local block also at 640 tokens, where its 512-token window masks
LM_BLOCKS = (("llama3-8b block", "llama3-8b", "layers", 1.0, 64),
             ("gemma3-1b local block", "gemma3-1b", "layers", 0.0, 64),
             ("gemma3-1b local block", "gemma3-1b", "layers", 0.0, 640),
             ("gemma3-1b global block", "gemma3-1b", "layers", 1.0, 64),
             ("deepseek-moe-16b dense-front block", "deepseek-moe-16b",
              "dense_front", 1.0, 64),
             ("deepseek-moe-16b MoE block", "deepseek-moe-16b", "layers",
              1.0, 64),
             ("qwen3-moe-30b-a3b MoE block (QK-norm)", "qwen3-moe-30b-a3b",
              "layers", 1.0, 64))
# L4: AutoInt's registered cells and the function each runs
AUTOINT_CELLS = (("serve_p99", "forward"), ("serve_bulk", "forward"),
                 ("retrieval_cand", "retrieval"), ("train_batch", "loss"))


def _free() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _lm_on_both(arch_id: str):
    """An LM at ``reduced_config`` (f32) drawn on the CPU from generator
    seed 0, and its copy on the card. -> (cfg, {"cpu": m, "cuda": m})."""
    import copy

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import build_lm
    cfg = reduced_config(arch_id).model
    cpu = build_lm(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    return cfg, {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}


def phase_lm_parity() -> None:
    """(L0): all five LMs and AutoInt at ``reduced_config`` in f32, card
    against CPU from one set of parameters: ``lm_forward`` (full, and
    blocked at 8-token chunks), ``lm_prefill_chunked`` then three
    ``lm_decode_step``s with the cache, and AutoInt's forward, retrieval
    scores and loss; ``rtol 1e-5`` of the largest magnitude."""
    import copy

    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import lm_token_stream, recsys_batch
    from repro_torch.models import recsys, transformer as tf

    with torch.no_grad():
        for arch_id in LM_IDS:
            cfg, models = _lm_on_both(arch_id)
            toks = lm_token_stream(7, 2, 35, cfg.vocab_size, device="cpu")
            runs = {}
            for dev, model in models.items():
                t = toks.to(dev)
                full = tf.lm_forward(model, t[:, :32])[0]
                blocked = tf.lm_forward(model, t[:, :32], q_chunk=8,
                                        kv_chunk=8)[0]
                cache = tf.init_decode_cache(cfg, 2, 36, torch.float32,
                                             device=dev)
                outs = [tf.lm_prefill_chunked(model, t[:, :32], cache,
                                              chunk=8)[0]]
                for i in range(3):
                    outs.append(tf.lm_decode_step(
                        model, cache, t[:, 32 + i:33 + i])[0])
                runs[dev] = (full, blocked, outs, cache)
            (f_c, b_c, o_c, c_c), (f_g, b_g, o_g, c_g) = runs["cpu"], \
                runs["cuda"]
            err = _close_to_largest(f"{arch_id} lm_forward", f_g, f_c, 1e-5)
            _close_to_largest(f"{arch_id} blocked", b_g, b_c, 1e-5)
            _close_to_largest(f"{arch_id} blocked vs full (card)", b_g, f_g,
                              1e-5)
            for i, (a, b) in enumerate(zip(o_g, o_c)):
                err = max(err, _close_to_largest(
                    f"{arch_id} serve step {i}", a, b, 1e-5))
            for k in ("k", "v", "k_front", "v_front"):
                _close_to_largest(f"{arch_id} cache {k}", c_g[k], c_c[k],
                                  1e-5)
            if not int(c_g["len"]) == int(c_c["len"]) == 35:
                raise AssertionError(f"{arch_id}: cache len {c_g['len']}")
            print(f"[lm] L0 {arch_id} reduced f32: forward, blocked, chunked "
                  f"prefill and 3 decode steps card == CPU, max err "
                  f"{err:.3e}", flush=True)
        arch = reduced_config("autoint")
        cpu = recsys.build_autoint(arch.model, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).to("cuda")
        train = recsys_batch(arch, "smoke_train", 3, device="cpu")
        ret = recsys_batch(arch, "smoke_retrieval", 4, device="cpu")
        outs = {}
        for dev, model in (("cpu", cpu), ("cuda", card)):
            tb = {k: v.to(dev) for k, v in train.items()}
            rb = {k: v.to(dev) for k, v in ret.items()}
            outs[dev] = (recsys.autoint_forward(model, tb),
                         recsys.retrieval_scores(model, rb, rb["candidates"],
                                                 rb["retrieval_proj"]),
                         recsys.autoint_loss(model, tb))
        errs = [_close_to_largest(f"autoint {name}", g, c, 1e-5)
                for name, g, c in zip(("forward", "retrieval", "loss"),
                                      outs["cuda"], outs["cpu"])]
        print(f"[lm] L0 autoint reduced f32: forward, retrieval scores, "
              f"loss card == CPU, max err {max(errs):.3e}", flush=True)


def _route_ids(block, x, cfg):
    """The router's top-k ids of a MoE block on input ``x`` and, per token,
    the gap between its k-th and (k+1)-th probabilities."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.moe import route
    h = x + L.attention(block.attn, L.rms_norm(block.ln1, x, cfg.norm_eps),
                        **block._attn_kw())
    hn = L.rms_norm(block.ln2, h, cfg.norm_eps).reshape(1, -1, cfg.d_model)
    probs, _, ids = route(block.moe, hn, cfg.moe.top_k)
    top = torch.sort(probs, dim=-1, descending=True).values
    k = cfg.moe.top_k
    return ids[0], (top[0, :, k - 1] - top[0, :, k])


def phase_lm_blocks() -> None:
    """(L1): one block of each kind at its registered width, f32, on 2 x
    64 tokens (gemma3's local block also on 2 x 640), drawn on the card
    from generator seed 0 and copied to the CPU: card against CPU within
    ``rtol 1e-5`` of the largest magnitude; MoE blocks route every token
    to the same experts, but for a token whose k-th and (k+1)-th
    probabilities lie within 1e-6 (printed, and left out of the output
    comparison)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Block

    dev = torch.device("cuda")
    for label, arch_id, stack, flag, s in LM_BLOCKS:
        cfg = dataclasses.replace(get_config(arch_id).model,
                                  param_dtype=torch.float32)
        moe = stack == "layers" and cfg.moe is not None
        t0 = time.perf_counter()
        block = Block(cfg, moe, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
        host = copy.deepcopy(block).cpu()
        x = torch.randn(2, s, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            out_g, aux_g = block(x.to(dev), flag)
            out_c, aux_c = host(x, flag)
            keep = torch.ones(2 * s, dtype=torch.bool)
            note = ""
            if moe:
                ids_g, gap = _route_ids(block, x.to(dev), cfg)
                ids_c, _ = _route_ids(host, x, cfg)
                differ = (ids_g.cpu() != ids_c).any(-1)
                tied = gap.cpu() < 1e-6
                if (differ & ~tied).any():
                    raise AssertionError(
                        f"{label}: tokens {differ.nonzero().tolist()} route "
                        f"to other experts on the card")
                for t in differ.nonzero().flatten().tolist():
                    print(f"[lm] L1 {label}: token {t} near-tied (gap "
                          f"{gap[t].item():.2e}), routed "
                          f"{ids_g[t].tolist()} on the card and "
                          f"{ids_c[t].tolist()} on the CPU; left out",
                          flush=True)
                keep = ~differ
                note = (f", top-{cfg.moe.top_k} ids equal for "
                        f"{int(keep.sum())}/{2 * s} tokens")
                if keep.all():
                    _close_to_largest(f"{label} aux", aux_g, aux_c, 1e-5)
        err = _close_to_largest(label, out_g.reshape(2 * s, -1)[keep.to(dev)],
                                out_c.reshape(2 * s, -1)[keep], 1e-5)
        params = sum(p.numel() for p in block.parameters())
        print(f"[lm] L1 {label} x {s} tokens, f32, {params} parameters: "
              f"card == CPU, max err {err:.3e}{note} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del block, host, out_g
        _free()


def phase_lm_consistency() -> None:
    """(L2): ``tests/test_chunked_prefill.py``'s checks at full width on
    the card, f32, 2 x 2048 tokens, chunk 512: chunked-prefill logits
    against ``lm_forward``'s last chunk (``2e-4`` of the largest
    magnitude), and the decode hand-off against ``lm_forward`` of the
    prompt plus the token (``2e-3``), for smollm-360m, gemma3-1b and
    llama3-8b (32 GB of f32 parameters)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    b, s, chunk = 2, 2048, 512
    for arch_id in ("smollm-360m", "gemma3-1b", "llama3-8b"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch_id).model,
                                  param_dtype=torch.float32)
        model = tf.build_lm(cfg, device=dev)
        toks = lm_token_stream(11, b, s + 1, cfg.vocab_size, device=dev)
        with torch.inference_mode():
            full = tf.lm_forward(model, toks[:, :s])[0][:, -chunk:].clone()
            cache = tf.init_decode_cache(cfg, b, s + 4, torch.float32,
                                         device=dev)
            out, cache = tf.lm_prefill_chunked(model, toks[:, :s], cache,
                                               chunk=chunk)
            e1 = _close_to_largest(f"{arch_id} chunked prefill", out, full,
                                   2e-4, atol=0.0)
            del full, out
            dec, cache = tf.lm_decode_step(model, cache, toks[:, s:])
            want = tf.lm_forward(model, toks)[0][:, -1:]
            e2 = _close_to_largest(f"{arch_id} decode hand-off", dec, want,
                                   2e-3, atol=0.0)
            if int(cache["len"]) != s + 1:
                raise AssertionError(f"{arch_id}: cache len {cache['len']}")
        print(f"[lm] L2 {arch_id} f32 {b}x{s} chunk {chunk}: chunked "
              f"prefill vs lm_forward max err {e1:.3e}, decode hand-off "
              f"{e2:.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del model, cache, dec, want
        _free()


def lm_serve_bytes(model, batch: int, prompt: int, chunk: int,
                   s_max: int) -> dict:
    """The analytic terms of a serving run's peak: the parameters as
    built, the cache (bf16), the last chunk's logits (f32, beside the
    bf16 product they are cast from), and one layer's attention scores
    at the last chunk (f32 masked logits beside their f32 softmax and the
    bf16 probabilities)."""
    cfg = model.cfg
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    cache = 2 * cfg.n_layers * batch * s_max * cfg.n_kv_heads \
        * cfg.head_dim * 2
    logits = batch * chunk * cfg.vocab_size * (4 + 2)
    scores = batch * cfg.n_heads * chunk * prompt * (4 + 4 + 2)
    return {"params": params, "cache": cache, "logits": logits,
            "scores": scores, "model": params + cache + max(logits, scores)}


def phase_lm_serving() -> dict:
    """(L3): each LM at its registered width and depth in bf16,
    parameters drawn on the card: a batch of 8 prompts of 2,048
    tokens through ``lm_prefill_chunked`` (chunk 1024) into a 2,080-row
    cache, then 32 greedy ``lm_decode_step``s (the first profiled, 31
    timed); llama3-8b also ``lm_prefill`` at 1 x 4096 (blocked attention).
    The MoE models' chunked prefill (2 x 2048, chunk 512) correlates with
    ``lm_forward`` (> 0.8, ``tests/test_chunked_prefill.py``'s check). One
    prefill chunk of llama3-8b and deepseek-moe-16b is profiled too.
    Returns the kernels' launches over the serving runs (none is due)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.models import transformer as tf

    dev = torch.device("cuda")
    b, s, chunk, steps = (LM_SERVE[k] for k in ("batch", "prompt", "chunk",
                                                 "steps"))
    s_max = s + steps
    _reset_counts()
    for seed, arch_id in enumerate(LM_IDS):
        cfg = get_config(arch_id).model
        t0 = time.perf_counter()
        model = tf.build_lm(cfg, device=dev)
        _sync()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        terms = lm_serve_bytes(model, b, s, chunk, s_max)
        prompt = lm_token_stream(seed, b, s, cfg.vocab_size, device=dev)
        cache = tf.init_decode_cache(cfg, b, s_max, device=dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, cache = tf.lm_prefill_chunked(model, prompt, cache,
                                                  chunk=chunk)
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            _sync()
            prefill_s = time.perf_counter() - t0
            # the peak before the check below, whose own temporaries
            # (``isfinite``'s f32 ``abs`` and masks) are not serving's
            peak = torch.cuda.max_memory_allocated()
            if not torch.isfinite(logits).all():
                raise AssertionError(f"{arch_id}: non-finite prefill logits")
            del logits
            torch.cuda.reset_peak_memory_stats()
            profiled = arch_id in ("llama3-8b", "deepseek-moe-16b")
            first = [tok]

            def step():
                lg, _ = tf.lm_decode_step(model, cache, first[0])
                first[0] = lg[:, -1:].argmax(-1).to(torch.int32)
            if profiled:
                _profile(f"{arch_id} one decode step (batch {b}, cache "
                         f"{s_max})", step)
            else:
                step()
            tok = first[0]
            _sync()
            t0 = time.perf_counter()
            for _ in range(steps - 1):
                lg, cache = tf.lm_decode_step(model, cache, tok)
                tok = lg[:, -1:].argmax(-1).to(torch.int32)
            _sync()
            decode_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
            if int(cache["len"]) != s_max or not torch.isfinite(lg).all():
                raise AssertionError(f"{arch_id}: decode ended at "
                                     f"{int(cache['len'])}")
            peak = max(peak, torch.cuda.max_memory_allocated())
            if profiled:
                _profile(f"{arch_id} the first prefill chunk ({b} x "
                         f"{chunk})",
                         lambda: tf.lm_prefill_chunked(
                             model, prompt[:, :chunk], cache, chunk=chunk))
            del lg, cache, prompt
            print(f"[lm] L3 {arch_id} bf16 {cfg.n_layers} layers "
                  f"d_model {cfg.d_model} vocab {cfg.vocab_size}: build "
                  f"{build_s:.2f} s; prefill {b}x{s} chunk {chunk}: "
                  f"{prefill_s:.3f} s, {b * s / prefill_s:.0f} tokens/s; "
                  f"decode {decode_ms:.2f} ms a step at batch {b} "
                  f"({b * 1e3 / decode_ms:.0f} tokens/s); peak {peak} B "
                  f"against the model {terms['model']} B "
                  f"({(peak - terms['model']) / terms['model']:+.3f}): "
                  f"params {terms['params']} + cache {terms['cache']} + "
                  f"max(last-chunk logits {terms['logits']}, attention "
                  f"scores {terms['scores']})", flush=True)
            if arch_id == "llama3-8b":
                toks = lm_token_stream(99, 1, 4096, cfg.vocab_size,
                                       device=dev)
                _sync()
                t0 = time.perf_counter()
                out = tf.lm_prefill(model, toks)
                _sync()
                sec = time.perf_counter() - t0
                if not torch.isfinite(out).all():
                    raise AssertionError("llama3-8b lm_prefill: non-finite")
                print(f"[lm] L3 llama3-8b lm_prefill 1x4096 (blocked "
                      f"attention, 1024-token blocks): {sec:.3f} s, "
                      f"{4096 / sec:.0f} tokens/s", flush=True)
                del out, toks
            if cfg.moe is not None:
                toks = lm_token_stream(50 + seed, 2, 2048, cfg.vocab_size,
                                       device=dev)
                full = tf.lm_forward(model, toks)[0][:, -512:]
                c2 = tf.init_decode_cache(cfg, 2, 2052, device=dev)
                out, c2 = tf.lm_prefill_chunked(model, toks, c2, chunk=512)
                corr = float(np.corrcoef(full.float().cpu().numpy().ravel(),
                                         out.float().cpu().numpy().ravel()
                                         )[0, 1])
                if not corr > 0.8 or int(c2["len"]) != 2048:
                    raise AssertionError(f"{arch_id}: chunked prefill "
                                         f"correlation {corr}")
                print(f"[lm] L2 {arch_id} bf16 2x2048 chunk 512: chunked "
                      f"prefill against lm_forward's last chunk, "
                      f"correlation {corr:.5f} (> 0.8)", flush=True)
                del full, out, c2, toks
        del model
        _free()
    return _read_counts()


def autoint_act_bytes(cfg, batch: int) -> int:
    """The analytic activations of an AutoInt forward at its widest: the
    gathered rows (single fields and bag rows) beside the field embeddings,
    or the second interacting layer at its logits product. There eight
    (B, F, d_attn) f32 tensors are live (the first layer's input, held by
    ``user_embedding``; this layer's input; its q, k and v; the first
    layer's attention output, held until ``att`` is bound again; and
    ``einsum``'s contiguous copies of q and k) beside three (B, H, F, F)
    (the first layer's scaled logits and softmax, held until bound again,
    and the new logits). ``autoint_live_at_peak`` lists the live blocks
    that back this count."""
    f = cfg.n_sparse + 1
    gather = batch * (cfg.n_sparse + cfg.bag_fields * cfg.bag_size
                      + 2 * f) * cfg.embed_dim * 4
    layer = batch * (8 * f * cfg.d_attn + 3 * cfg.n_heads * f * f) * 4
    return max(gather, layer)


def autoint_live_at_peak(fn, cfg, batch: int) -> int:
    """Run ``fn`` once under the CUDA allocator's history, replay the
    trace to its highest point and print the blocks live there, each by
    its size class and the line of ``recsys.py`` that allocated it.
    -> the bytes live at that point beyond those live before ``fn``."""
    import collections

    import torch

    f = cfg.n_sparse + 1
    kinds = {batch * f * cfg.d_attn * 4: "(B,F,d_attn) f32",
             batch * cfg.n_heads * f * f * 4: "(B,H,F,F) f32"}
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=100_000)
    try:
        out = fn()
        _sync()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    live, cur, top, at_top = {}, 0, 0, {}
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > top:
                top, at_top = cur, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]

    def where(ev):
        for fr in ev.get("frames", ()):
            if fr["filename"].endswith("recsys.py"):
                return f"recsys.py:{fr['line']} {fr['name']}"
        return "elsewhere"
    groups = collections.Counter(
        (kinds.get(ev["size"], f"{ev['size']} B"), where(ev))
        for ev in at_top.values())
    print(f"[lm] L4 autoint batch {batch}: {len(at_top)} blocks, {top} B "
          f"live at the forward's peak:", flush=True)
    for (kind, line), n in sorted(groups.items(), key=lambda kv: kv[0][1]):
        print(f"[lm]   {n} x {kind} from {line}", flush=True)
    return top


def phase_autoint_cells() -> dict:
    """(L4): AutoInt at its registered width and cells in f32 (tables
    39 x 1,000,000 x 16 on the card): ``serve_p99`` (512), ``serve_bulk``
    (262,144), ``retrieval_cand`` (1 query x 1,048,576 candidates x 64)
    and ``train_batch`` (65,536, forward and loss). ms a batch by CUDA
    events after one untimed call, and the peak beside parameters +
    batch + activations. Returns the kernels' launches (none is due)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models import recsys

    dev = torch.device("cuda")
    arch = get_config("autoint")
    cfg = arch.model
    _reset_counts()
    model = recsys.build_autoint(cfg, device=dev)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    for seed, (cell, kind) in enumerate(AUTOINT_CELLS):
        batch = recsys_batch(arch, cell, seed, device=dev)
        b = batch["dense"].shape[0]
        fn = {"forward": lambda: recsys.autoint_forward(model, batch),
              "loss": lambda: recsys.autoint_loss(model, batch),
              "retrieval": lambda: recsys.retrieval_scores(
                  model, batch, batch["candidates"],
                  batch["retrieval_proj"])}[kind]
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            _sync()
            peak = torch.cuda.max_memory_allocated()
            if not torch.isfinite(out).all():
                raise AssertionError(f"autoint {cell}: non-finite output")
            shape = tuple(out.shape)
            del out
            reps = 20 if b <= 65_536 else 5
            ms = _time_ms(fn, reps)
        batch_bytes = sum(v.numel() * v.element_size()
                          for v in batch.values())
        act = autoint_act_bytes(cfg, b)
        if cell == "serve_bulk":
            with torch.inference_mode():
                listed = autoint_live_at_peak(fn, cfg, b)
            print(f"[lm] L4 autoint serve_bulk: {listed} B listed against "
                  f"the analytic activations {act} B "
                  f"({(listed - act) / act:+.4f})", flush=True)
        if kind == "retrieval":
            act += b * batch["candidates"].shape[0] * 4
        model_b = params + batch_bytes + act
        print(f"[lm] L4 autoint {cell} ({kind}, batch {b}, output "
              f"{shape}): {ms:.3f} ms a batch ({b / ms * 1e3:.0f} rows/s); "
              f"peak {peak} B against params {params} + batch "
              f"{batch_bytes} + activations {act} = {model_b} B "
              f"({(peak - model_b) / model_b:+.3f})", flush=True)
        del batch
    del model
    _free()
    return _read_counts()


# ------------------------------------------------------------ (T) training
TRAIN_T1 = dict(batch=16, microbatches=8)        # train_4k: 256 cut to 16
TRAIN_T1_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=8)
TRAIN_MB = ("smollm-360m", "autoint")            # microbatches 2 in T0


def _state_copy(arch, state, d_in, device):
    """A train state's copy on ``device``, bit for bit."""
    from repro_torch import interop
    return interop.train_state_from_arrays(
        arch, interop.train_state_to_arrays(state), d_in, device=device)


def _state_errors(label: str, got, want, rtol: float, *,
                  one_step: bool = False) -> float:
    """Every leaf of two train states within ``rtol`` of the leaf's
    largest magnitude (``_close_to_largest``), the step equal.
    ``one_step``: the int8-compressed DDP's moments within ``2 / 127`` and
    its residuals within one quantization step, under 1% of the elements
    a step apart (an element whose ``(g + r) / scale`` the two devices'
    rounding puts on either side of a rounding boundary sums one step
    apart, until error feedback gives it back). -> the largest error
    relative to its leaf's largest magnitude."""
    from repro_torch.train.step import state_leaves
    a, b = state_leaves(got), state_leaves(want)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise AssertionError(f"{label}: the states' leaves differ")
    worst = 0.0
    for (path, ga), (_, gb) in zip(a, b):
        y = gb().detach()
        x = ga().detach().to(y.device)     # on the reference's device
        name = f"{label} {'/'.join(map(str, path))}"
        if path == ("opt", "step"):
            if int(x) != int(y):
                raise AssertionError(f"{name}: {int(x)} against {int(y)}")
            continue
        if not y.numel():
            continue
        d = (x.double() - y.double()).abs()
        err, scale = d.max().item(), y.double().abs().max().item()
        if one_step and path[0] == "residual":
            if err > 1.01 * 2 * scale or \
                    (d > scale / 2).double().mean().item() >= 0.01:
                raise AssertionError(f"{name}: more than one step apart")
            continue
        tol = 2 / 127 if one_step and path[0] == "opt" else rtol
        if not err <= 1e-6 + tol * scale:
            raise AssertionError(f"{name}: {err!r} over 1e-06 + {tol} * "
                                 f"{scale!r}")
        worst = max(worst, err / scale if scale else 0.0)
    return worst


def phase_train_parity() -> None:
    """(T0): every registered architecture at ``reduced_config``, card
    against CPU from one CPU-drawn train state and the same batches
    (``build_train_step``, the reference's default AdamW): one step (the
    loss, ``grad_norm``, ``lr``, every parameter and moment within ``rtol
    1e-5`` of its largest magnitude), then five (``1e-4``); and one step
    of 2 microbatches for smollm-360m and AutoInt. (A GNN batch splits
    into microbatches in neither package: both split the ``(2, E)`` edge
    list's leading dim.)"""
    import torch

    from repro_torch.configs import ARCH_IDS, reduced_config
    from repro_torch.data.synthetic import make_batch, statics_for
    from repro_torch.train.step import build_train_step, concrete_train_state

    for arch_id in ARCH_IDS:
        arch = reduced_config(arch_id)
        cell = next(c for c in arch.cells if c.kind == "train")
        d_in = cell.dims.get("d_feat")
        statics = statics_for(arch, cell.name)
        cases = [(1, 5)] + ([(2, 1)] if arch_id in TRAIN_MB else [])
        for microbatches, steps in cases:
            cpu = concrete_train_state(arch, 0, d_in, device="cpu")
            card = _state_copy(arch, cpu, d_in, "cuda")
            fn = build_train_step(arch, statics=statics,
                                  microbatches=microbatches)
            errs, losses = [], []
            for i in range(steps):
                batch = make_batch(arch, cell.name, i, device="cpu")
                cpu, want = fn(cpu, batch)
                card, got = fn(card, {k: v.cuda() for k, v in batch.items()})
                rtol = 1e-5 if i == 0 else 1e-4
                for k in ("loss", "grad_norm", "lr"):
                    _close_to_largest(f"T0 {arch_id} step {i} {k}", got[k],
                                      want[k], rtol)
                losses.append(float(got["loss"]))
                if i == 0:
                    errs.append(_state_errors(f"T0 {arch_id} step 1", card,
                                              cpu, 1e-5))
            if steps > 1:
                errs.append(_state_errors(f"T0 {arch_id} step {steps}",
                                          card, cpu, 1e-4))
            print(f"[train] T0 {arch_id} {cell.name} microbatches="
                  f"{microbatches}: card against CPU, largest leaf error "
                  f"{errs} of its largest magnitude over {steps} step(s); "
                  f"losses {losses}", flush=True)
            del cpu, card
    _free()


def lm_train_bytes(cfg, n_params: int, b_mb: int, s: int,
                   q_chunk: int = 1024) -> dict:
    """The analytic peak of a remat LM train step of ``b_mb``-sequence
    microbatches, from the code: the state (bf16 parameters, f32
    accumulators, f32 ``mu``/``nu``) and one microbatch's bf16 gradients
    (``torch.autograd.grad`` returns them together); remat's block inputs
    (one ``(b, s, d)`` a block); and the larger of the head and one
    block's recompute. The head peaks in ``lm_loss``'s backward with four
    f32 ``(b, s, V)`` tensors live (the logits, which ``logsumexp`` and
    the target gather keep; ``logsumexp``'s backward exponential and its
    product with the incoming gradient; the gather's scattered gradient)
    and the bf16 gradient of ``x @ lm_head``. One block's recompute keeps,
    per causal (q, kv) chunk pair of the blocked attention, the f32 logits
    and probabilities."""
    item = 2 if cfg.param_dtype.itemsize == 2 else 4
    state = n_params * (item + 4 + 8) + n_params * item
    remat = cfg.n_layers * b_mb * s * cfg.d_model * item
    head = b_mb * s * cfg.vocab_size * (4 * 4 + item)
    nq = -(-s // q_chunk)
    pairs = nq * (nq + 1) // 2
    block = pairs * 2 * b_mb * cfg.n_heads * q_chunk * q_chunk * 4
    return {"state": state, "remat_inputs": remat, "head": head,
            "block_recompute": block,
            "total": state + remat + max(head, block)}


def _bf16_matmul_tflops() -> float:
    """A bf16 ``torch.matmul`` at 8192^3 on this card, TFLOP/s."""
    import torch
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    _time_ms(lambda: a @ b, 5)
    ms = _time_ms(lambda: a @ b, 20)
    del a, b
    return 2 * 8192 ** 3 / (ms * 1e-3) / 1e12


def phase_train_lm_full() -> tuple:
    """(T1): smollm-360m at its registered widths and depth (32 layers, d
    960, 15/5 heads, d_ff 2,560, vocab 49,152, bf16 parameters, remat),
    ``train_4k`` (seq 4,096) with the batch cut from 256 to 16, 8
    microbatches of 2: one untimed step, five timed (s/step, tokens/s,
    model TFLOP/s from ``model_flops`` and its share of a bf16 matmul's
    rate measured here), the peak beside ``lm_train_bytes``; a checkpoint
    after step 3 (4.09 GB of parameters and moments, several shard files)
    restored into a fresh state bit for bit, whose steps 4-5 match the
    uninterrupted run within ``1e-4``; one step profiled. -> (the model,
    its arch with the cut cell, seconds a step)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.step import (build_train_step,
                                        concrete_train_state, state_leaves)

    full = get_config("smollm-360m")
    cut = ShapeCell("train_4k", "train", {"seq": 4096,
                                          "batch": TRAIN_T1["batch"]})
    arch = dataclasses.replace(full, cells=(cut,) + tuple(
        c for c in full.cells if c.name != "train_4k"))
    cfg = arch.model
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.param_dtype, cfg.remat) != (
            32, 960, 15, 5, 2560, 49152, torch.bfloat16, True):
        raise AssertionError(f"smollm-360m is not at its registered width: "
                             f"{cfg}")
    mb = TRAIN_T1["microbatches"]
    _free()
    state = concrete_train_state(arch, 0, device="cuda")
    n_params = sum(p.numel() for p in state["params"].parameters())
    if n_params != 409_007_040:
        raise AssertionError(f"smollm-360m has {n_params} parameters")
    step = build_train_step(arch, AdamWConfig(**TRAIN_T1_OPT),
                            microbatches=mb)
    batches = [make_batch(arch, "train_4k", 100 + i, device="cuda")
               for i in range(6)]
    torch.cuda.reset_peak_memory_stats()
    losses = []

    def run(st, i):
        st, m = step(st, batches[i])
        losses.append(float(m["loss"]))
        return m

    t_first = time.perf_counter()
    run(state, 0)                                   # untimed
    _sync()
    t_first = time.perf_counter() - t_first
    t0 = time.perf_counter()
    for i in (1, 2, 3):
        run(state, i)
    _sync()
    timed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t_round = time.perf_counter()
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, 4, state, extras={"step": 4})
        write_s = time.perf_counter() - t0
        files = sorted(f for f in os.listdir(path) if f.endswith(".npz"))
        on_disk = sum(os.path.getsize(os.path.join(path, f)) for f in files)
        fresh = concrete_train_state(arch, 1, device="cuda")
        _sync()
        t0 = time.perf_counter()
        restore_checkpoint(tmp, fresh)
        _sync()
        read_s = time.perf_counter() - t0
        for (p, a), (_, b) in zip(state_leaves(fresh), state_leaves(state)):
            x, y = a(), b()
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"T1 restored leaf {p} differs")
        _sync()
        t0 = time.perf_counter()
        for i in (4, 5):
            run(state, i)
        _sync()
        timed += time.perf_counter() - t0
        after = []
        for i in (4, 5):
            fresh, m = step(fresh, batches[i])
            after.append(float(m["loss"]))
        for got, want in zip(after, losses[4:6]):
            _close_to_largest("T1 resumed loss", torch.tensor(got),
                              torch.tensor(want), 1e-4)
        err = _state_errors("T1 resumed", fresh, state, 1e-4)
        t_round = time.perf_counter() - t_round
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _free()
    sec = timed / 5
    tokens = cut.dims["batch"] * cut.dims["seq"]
    flops = model_flops(arch, cut)
    peak_rate = _bf16_matmul_tflops()
    model = lm_train_bytes(cfg, n_params, cut.dims["batch"] // mb,
                           cut.dims["seq"])
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"T1 non-finite loss: {losses}")
    print(f"[train] T1 smollm-360m train_4k cut to batch {cut.dims['batch']} "
          f"(seq {cut.dims['seq']}, {mb} microbatches of "
          f"{cut.dims['batch'] // mb}): params={n_params} "
          f"s_per_step={sec!r} tokens_per_s={tokens / sec:.1f} "
          f"model_flops={flops:.6e} model_tflops={flops / sec / 1e12:.2f} "
          f"= {flops / sec / 1e12 / peak_rate:.3f} of a bf16 8192^3 "
          f"matmul's {peak_rate:.1f} TFLOP/s; max_memory_allocated={peak} "
          f"({peak / GIB:.2f} GiB) against the analytic {model['total']} "
          f"({(peak - model['total']) / model['total']:+.3f}: state "
          f"{model['state']} + remat block inputs {model['remat_inputs']} + "
          f"the larger of the head {model['head']} and one block's "
          f"recompute {model['block_recompute']}); losses {losses}",
          flush=True)
    print(f"[train] T1 checkpoint after step 3: {len(files)} shard files, "
          f"{on_disk} B on disk, write {write_s:.2f} s, read {read_s:.2f} s; "
          f"every restored leaf bit-equal; steps 4-5 from it {after} "
          f"against {losses[4:6]}, largest state error {err:.3e} of its "
          f"leaf's largest magnitude; the untimed first step {t_first:.1f} "
          f"s, the round trip with the timed steps 4-5 {t_round:.1f} s",
          flush=True)
    if len(files) < 4:
        raise AssertionError(f"T1 checkpoint in {len(files)} shard files")
    t0 = time.perf_counter()
    _profile(f"T1 smollm-360m train_4k/{cut.dims['batch']}, one step of "
             f"{mb} microbatches", lambda: step(state, batches[0]), cpu=False)
    print(f"[train] T1 the profiled step and its parse took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    model_mod = state["params"]
    del state, batches
    _free()
    return model_mod, arch, sec, peak


def phase_train_autoint() -> None:
    """(T2): AutoInt at its registered ``train_batch`` (65,536), f32,
    tables 39 x 1,000,000 x 16 (2,496,000,000 B), no cut: one untimed
    ``build_train_step`` step, three timed; the peak beside the batch and
    the larger of AdamW's update (the parameters, their gradients, the
    moments, the clipped gradients, and at the largest leaf its new
    ``mu``, ``nu`` and three live temporaries, from the code) and the
    forward (the parameters, the moments and PR 22's activation count; no
    activation outlives the backward)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.train.step import build_train_step, concrete_train_state

    _free()
    arch = get_config("autoint")
    state = concrete_train_state(arch, 0, device="cuda")
    params = list(state["params"].parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params)
    largest = max(p.numel() * 4 for p in params)
    batch = make_batch(arch, "train_batch", 0, device="cuda")
    b = batch["dense"].shape[0]
    step = build_train_step(arch)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(state, batch)[1]["loss"])]
    _sync()
    t0 = time.perf_counter()
    for _ in range(3):
        losses.append(float(step(state, batch)[1]["loss"]))
    _sync()
    sec = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated()
    batch_bytes = sum(v.numel() * v.element_size() for v in batch.values())
    act = autoint_act_bytes(arch.model, b)
    update = 5 * p_bytes + 5 * largest
    forward = 3 * p_bytes + act
    model = max(update, forward) + batch_bytes
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"T2 non-finite loss: {losses}")
    print(f"[train] T2 autoint train_batch (batch {b}, no cut): "
          f"s_per_step={sec!r} rows_per_s={b / sec:.0f}; "
          f"max_memory_allocated={peak} ({peak / GIB:.2f} GiB) against "
          f"batch {batch_bytes} + the larger of AdamW's update, 5 x params "
          f"{p_bytes} (parameters, gradients, mu, nu, clipped gradients) + "
          f"5 x the largest leaf {largest} (its new mu and nu and three "
          f"live temporaries) = {update}, and the forward, 3 x params + "
          f"activations {act} = {forward}: {model} "
          f"({(peak - model) / model:+.3f}); losses {losses}", flush=True)
    del state, batch, params
    _free()


def phase_train_launcher() -> None:
    """(T3): ``launch.train.main`` on the card: reduced smollm-360m for
    10 steps (checkpoints every 3 under ``TMPDIR``) stopped when step 6's
    batch is asked for, then resumed to step 10, its last loss within
    ``1e-4`` of a straight 10-step run's; then graphsage-reddit at
    ``smoke_full`` and AutoInt at ``--reduced``."""
    import shutil
    import tempfile

    import torch

    from repro_torch.launch import train as launch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    args = ["--arch", "smollm-360m", "--reduced", "--steps", "10",
            "--ckpt-every", "3", "--device", "cuda"]
    real = launch.make_batch

    def stop_at_6(arch, cell, seed, **kw):
        if seed == launch.batch_seed(6):
            raise KeyboardInterrupt("stopped at step 6")
        return real(arch, cell, seed, **kw)
    try:
        _, straight = launch.main(args + ["--ckpt", f"{tmp}/straight"])
        launch.make_batch = stop_at_6
        try:
            launch.main(args + ["--ckpt", f"{tmp}/resumed"])
            raise AssertionError("T3: the first run was not stopped")
        except KeyboardInterrupt:
            pass
        finally:
            launch.make_batch = real
        state, resumed = launch.main(args + ["--ckpt", f"{tmp}/resumed"])
        err = _close_to_largest("T3 resumed loss", resumed["loss"],
                                straight["loss"], 1e-4)
        if state["opt"].param_groups[0]["step"] != 10:
            raise AssertionError("T3: the resumed run did not reach step 10")
        print(f"[train] T3 launcher smollm-360m --reduced: resumed from step "
              f"6 to 10, last loss {float(resumed['loss'])!r} against the "
              f"straight run's {float(straight['loss'])!r} (error {err:.3e})",
              flush=True)
        for argv in (["--arch", "graphsage-reddit", "--reduced", "--cell",
                      "smoke_full"], ["--arch", "autoint", "--reduced"]):
            _, m = launch.main(argv + ["--steps", "5", "--device", "cuda"])
            if not torch.isfinite(m["loss"]):
                raise AssertionError(f"T3 {argv}: loss {m['loss']}")
            print(f"[train] T3 launcher {argv[1]}: 5 steps, last loss "
                  f"{float(m['loss'])!r}", flush=True)
    finally:
        launch.make_batch = real
        shutil.rmtree(tmp, ignore_errors=True)
    _free()


def phase_train_ddp(model, arch) -> None:
    """(T4): ``build_ddp_step`` under NCCL at world size 1
    (``FileStore`` under ``TMPDIR``): reduced smollm-360m, compressed and
    plain, 3 steps each, held to the same steps on a gloo group of 1 on
    the CPU (plain: every leaf within ``1e-5``; compressed: the parameters
    and loss within ``1e-5``, see ``_state_errors``); then one compressed
    and one plain DDP step of T1's model at one of its microbatches (2 x
    4,096 tokens), each timed after an untimed one. The process group is
    destroyed before it returns."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, reduced_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.transformer import build_lm
    from repro_torch.train.ddp import build_ddp_step, init_ddp_state
    from repro_torch.train.step import state_leaves

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        gloo = dist.new_group(backend="gloo")
        small = reduced_config("smollm-360m")
        for compress in (True, False):
            states = {}
            for dev in ("cpu", "cuda"):
                lm = build_lm(small.model, device="cpu",
                              generator=torch.Generator().manual_seed(0))
                states[dev] = init_ddp_state(lm, device=dev)
            fns = {"cuda": build_ddp_step(small, compress=compress),
                   "cpu": build_ddp_step(small, gloo, compress=compress)}
            losses = []
            for i in range(3):
                batch = make_batch(small, "smoke_train", i, device="cpu")
                out = {}
                for dev in ("cpu", "cuda"):
                    states[dev], out[dev] = fns[dev](
                        states[dev], {k: v.to(dev) for k, v in batch.items()})
                for k in ("loss", "grad_norm") if not compress else ("loss",):
                    _close_to_largest(f"T4 step {i} {k}", out["cuda"][k],
                                      out["cpu"][k], 1e-5)
                losses.append(float(out["cuda"]["loss"]))
            err = _state_errors(f"T4 {'int8' if compress else 'f32'}",
                                states["cuda"], states["cpu"], 1e-5,
                                one_step=compress)
            print(f"[train] T4 ddp reduced smollm-360m "
                  f"{'int8-compressed' if compress else 'plain'} at nccl "
                  f"world 1 against gloo world 1 on the CPU: 3 steps, "
                  f"losses {losses}, largest error {err:.3e}", flush=True)
        del states
        _free()

        cell = ShapeCell("train_4k", "train", {
            "seq": 4096, "batch": TRAIN_T1["batch"] // TRAIN_T1[
                "microbatches"]})
        big = dataclasses.replace(arch, cells=(cell,))
        state = init_ddp_state(model, device="cuda")
        n = sum(p.numel() for p in model.parameters())
        batch = make_batch(big, "train_4k", 7, device="cuda")
        for compress in (True, False):
            fn = build_ddp_step(big, compress=compress)
            fn(state, batch)                          # untimed
            _sync()
            t0 = time.perf_counter()
            _, m = fn(state, batch)
            _sync()
            sec = time.perf_counter() - t0
            if not torch.isfinite(m["loss"]):
                raise AssertionError(f"T4 full: loss {m['loss']}")
            # the int8 values are summed as int32 (both packages), beside
            # one f32 maximum a leaf
            leaves = sum(1 for p, _ in state_leaves(state)
                         if p[0] == "params")
            payload = 4 * n + 4 * leaves if compress else 4 * n
            how = (f"int8 quantized, summed in int32, {leaves} leaf "
                   f"maxima" if compress else "f32")
            print(f"[train] T4 ddp smollm-360m {cell.dims['batch']} x 4096 "
                  f"{'int8-compressed' if compress else 'plain'} at nccl "
                  f"world 1: s_per_step={sec!r} all-reduce payload "
                  f"{payload} B ({how}; f32 is {4 * n} B); loss "
                  f"{float(m['loss'])!r}", flush=True)
        del state, batch
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    _free()


def phase_train() -> tuple[dict, int]:
    """(T) training on the card: T0-T4. Returns the kernels' launches
    over the phase (none is due: the training path reaches no counting
    kernel) and T1's peak."""
    t0 = time.perf_counter()
    _reset_counts()
    took = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t, 1)
        return out
    timed("T0", phase_train_parity)
    model, arch, _, t1_peak = timed("T1", phase_train_lm_full)
    timed("T2", phase_train_autoint)
    timed("T3", phase_train_launcher)
    timed("T4", phase_train_ddp, model, arch)
    del model
    _free()
    counts = _read_counts()
    print(f"[train] phase (T) took {time.perf_counter() - t0:.1f} s "
          f"({took} s)", flush=True)
    return counts, t1_peak


DRYRUN_TIMEOUT_S = 420         # each of (Y2)'s launcher runs
DRYRUN_PEAK_SLACK = (0.8, 1.25)  # the reference's own memory slack
DRYRUN_RANK_BYTES = 80e9 * 1.25  # an H100's 80 GB, with that slack


def _dryrun_vs_card(g) -> dict:
    """(Y1): (D)'s configuration, u12 dedup on the mesh at mesh ``(1,
    1)``: one real coloring under NCCL at world size 1 (after an untimed
    one), its flops counted by ``FlopCounterMode`` (the kernels' ops carry
    their formulas) and its peak by ``max_memory_allocated`` above what
    was allocated before the ``DistributedPgbsc`` was built; then the same
    walk traced in the abstract mode on a fake process group with the
    graph's ``n``, ``e`` and ``e_max`` (one data shard: every edge). The
    traced flops must equal the counted ones exactly, and the predicted
    ``argument_bytes + temp_bytes`` lie within the reference's slack of
    the measured peak. -> the kernels' launches in the real coloring."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import hlo
    from repro_torch.core.distributed import DistributedPgbsc
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    src, _ = g.edges_by_dst
    dims = {"n": g.n, "e": int(len(src)), "e_max": int(len(src))}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        _free()
        base = torch.cuda.memory_allocated()
        dpg = DistributedPgbsc(g, "u12", make_mesh((1, 1), ("data", "model")),
                               plan="dedup")
        dpg.count_iterations([0], seed=0)        # NCCL's first collective
        _sync()
        _reset_counts()
        base_peak = torch.cuda.memory_allocated()
        with FlopCounterMode(display=False) as fc:
            _, per = dpg.count_iterations([0], seed=0)
        _sync()
        launches = _read_counts()
        measured = torch.cuda.max_memory_allocated() - base
        real_args = base_peak - base
        counted = fc.get_total_flops()
        del dpg
        _free()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    with dryrun.fake_world(1):
        mesh = dryrun._mesh((1, 1), ("data", "model"), torch.device("cuda"))
        rec = dryrun.trace_pgbsc("u12 on the mesh", mesh, 1, dims=dims,
                                 template="u12")
    mem = rec["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    ratio = predicted / measured
    print(f"[dryrun] Y1 u12 dedup on the mesh, mesh (1, 1), {_device_line()}"
          f": traced flops {rec['roofline']['flops']:.0f} against "
          f"FlopCounterMode's {counted} over one real coloring (sum "
          f"{per[0]!r}); predicted argument + temp bytes {predicted} "
          f"(arguments {mem['argument_bytes']}, real {real_args}) against "
          f"the measured peak {measured} above the rank's start, ratio "
          f"{ratio:.4f}; traced collectives {rec['collectives']}; ops "
          f"{rec['hlo_ops']}; trace {rec['compile_s']} s; launches "
          f"{launches}", flush=True)
    if rec["roofline"]["flops"] != counted or counted <= 0:
        raise AssertionError(f"(Y1) traced flops {rec['roofline']['flops']}"
                             f" != counted {counted}")
    if not DRYRUN_PEAK_SLACK[0] <= ratio <= DRYRUN_PEAK_SLACK[1]:
        raise AssertionError(f"(Y1) predicted peak {predicted} is "
                             f"{ratio:.4f} of the measured {measured}")
    if min(launches["spmm_gather"], launches["ema"]) == 0:
        raise AssertionError(f"(Y1) did not launch its kernels: {launches}")
    return launches


def _dryrun_cli() -> None:
    """(Y2): ``python -m repro_torch.launch.dryrun`` on the card's host,
    as a user runs it: every PGBSC cell on both production meshes, then
    llama3-8b ``decode_32k`` (with the reference's decode hints) and
    nequip ``ogb_products`` (61.9M edges, a strided shard of split factor
    ``E / 16``: DTensor's bookkeeping in the tracer's closed forms) on the
    single mesh; each record's flops, bytes and collective bytes a rank,
    dominant term, collectives and trace seconds. Every PGBSC record and
    the nequip one must be ``ok``. Then :func:`_dryrun_moe`."""
    import shutil
    import tempfile

    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_out_")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    try:
        for args in (["--arch", "pgbsc", "--mesh", "both"],
                     ["--arch", "llama3-8b", "--cell", "decode_32k",
                      "--mesh", "single"],
                     ["--arch", "nequip", "--cell", "ogb_products",
                      "--mesh", "single"]):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--out", out], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=DRYRUN_TIMEOUT_S)
            print(f"[dryrun] Y2 {' '.join(args)}: exit {res.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        recs = []
        for f in sorted(os.listdir(out)):
            if f.endswith(".json"):
                with open(os.path.join(out, f)) as fh:
                    recs.append(json.load(fh))
        for r in recs:
            tag = f"{r['arch']}/{r['cell']}/{r['mesh']}"
            if not r.get("ok"):
                print(f"[dryrun] Y2 {tag}: FAILED {r.get('error')}\n"
                      f"{r.get('traceback', '')[-1500:]}", flush=True)
                continue
            rf = r["roofline"]
            print(f"[dryrun] Y2 {tag} ({r['chips']} ranks, peaks "
                  f"{r['peaks']['name']}; traced on {_device_line()}): "
                  f"flops/rank {rf['flops']:.6e} bytes/rank "
                  f"{rf['bytes']:.6e} collective bytes/rank "
                  f"{rf['collective_bytes']:.6e} dominant {rf['dominant']} "
                  f"step bound {rf['step_time_s']:.6e} s; argument "
                  f"{r['memory']['argument_bytes']} temp "
                  f"{r['memory']['temp_bytes']} B; collectives "
                  f"{r['collectives']}; trace {r['compile_s']} s; "
                  f"bookkeeping {r['bookkeeping_bytes']} B; source "
                  f"{r['source']}", flush=True)
        pgbsc = [r for r in recs if r["arch"] == "pgbsc"]
        if len(pgbsc) != 8 or not all(r.get("ok") for r in pgbsc):
            states = [(r["cell"], r["mesh"], r.get("ok")) for r in pgbsc]
            raise AssertionError(f"(Y2) PGBSC records: {states}")
        if not any(r["arch"] == "nequip" and r.get("ok") for r in recs):
            raise AssertionError("(Y2) nequip ogb_products: no ok record")
    finally:
        shutil.rmtree(out, ignore_errors=True)


DRYRUN_MOE_LAYERS = 2     # (Y2)'s qwen3-moe-30b-a3b, cut from 48 layers


def _dryrun_moe() -> None:
    """(Y2), last: qwen3-moe-30b-a3b ``train_4k`` (batch 256, 8
    microbatches) on the single mesh at its registered widths (128
    experts, top 8), its depth cut to :data:`DRYRUN_MOE_LAYERS` MoE layers
    (deepseek-moe-16b ``prefill_32k`` takes 373 s to trace on the card's
    host), traced in this process as the launcher traces a record: the
    MoE dispatch per group (its groups split over ``data``) and the loss
    as vocab reductions. Its argument + temp bytes must be under 80 GB x
    1.25 (the parent's loss alone made a 79.7 GB replicated ``(B, S, V)``
    zeros) and no ``index_add`` may run whole."""
    import dataclasses

    from repro_torch.analysis import hlo
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.train import op_sharding

    full = get_config("qwen3-moe-30b-a3b")
    arch = dataclasses.replace(full, model=dataclasses.replace(
        full.model, n_layers=DRYRUN_MOE_LAYERS))
    op_sharding.install()
    t0 = time.perf_counter()
    with dryrun.fake_world(256):
        dev = hlo.trace_device(autograd=True)
        mesh = dryrun._mesh((16, 16), ("data", "model"), dev)
        rec = dryrun.trace_arch(dryrun._moe_grouped(arch, mesh), "train_4k",
                                mesh, 256, dev)
    m = rec["memory"]
    total = m["argument_bytes"] + m["temp_bytes"]
    whole = {k: v for k, v in rec["ran_whole"].items() if "index_add" in k}
    print(f"[dryrun] Y2 qwen3-moe-30b-a3b/train_4k/single at "
          f"{DRYRUN_MOE_LAYERS} of 48 layers (256 ranks, traced on "
          f"{_device_line()}): argument + temp {total} B against "
          f"{DRYRUN_RANK_BYTES:.0f} B; flops/rank "
          f"{rec['roofline']['flops']:.6e} collectives {rec['collectives']};"
          f" ran_whole {rec['ran_whole']}; trace {rec['compile_s']} s, "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    if total >= DRYRUN_RANK_BYTES or whole:
        raise AssertionError(f"(Y2) qwen3-moe-30b-a3b train_4k: {total} B a "
                             f"rank, index_add run whole {whole}")


def _dryrun_t1(t1_peak: int) -> None:
    """(Y3): T1's smollm-360m step traced at a ``(1, 1)`` mesh at T1's
    microbatch shape (2 sequences of 4,096 tokens, bf16, remat) with 2 of
    its 8 microbatches: the peak is one microbatch's, with the float32
    accumulators live, so 2 microbatches reach it as 8 do, at a quarter
    of the trace. Its predicted peak is printed beside T1's measured one,
    not held."""
    import dataclasses

    import torch

    from repro_torch.analysis import hlo
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun

    full = get_config("smollm-360m")
    per_mb = TRAIN_T1["batch"] // TRAIN_T1["microbatches"]
    cut = ShapeCell("train_4k", "train", {"seq": 4096, "batch": 2 * per_mb})
    arch = dataclasses.replace(full, cells=(cut,))
    with dryrun.fake_world(1):
        dev = hlo.trace_device(autograd=True)
        mesh = dryrun._mesh((1, 1), ("data", "model"), dev)
        rec = dryrun.trace_arch(arch, "train_4k", mesh, 1, dev,
                                microbatches=2)
    mem = rec["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    print(f"[dryrun] Y3 smollm-360m train_4k at T1's microbatch (2 x 4096, "
          f"2 microbatches), mesh (1, 1) on fake {dev.type} tensors, "
          f"{_device_line()}: predicted argument + temp bytes {predicted} "
          f"(arguments {mem['argument_bytes']}, temp {mem['temp_bytes']}) "
          f"beside T1's measured max_memory_allocated {t1_peak} (ratio "
          f"{predicted / t1_peak:.4f}); flops {rec['roofline']['flops']:.6e} "
          f"ops {rec['hlo_ops']}; trace {rec['compile_s']} s", flush=True)


def phase_dryrun(g, t1_peak: int) -> dict:
    """(Y) the dry run against the card: Y1-Y3. Returns the kernels'
    launches over the phase (Y1's real coloring)."""
    t0 = time.perf_counter()
    took = {}
    t = time.perf_counter()
    launches = _dryrun_vs_card(g)
    took["Y1"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    _dryrun_cli()
    _dryrun_moe()
    took["Y2"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    _dryrun_t1(t1_peak)
    took["Y3"] = round(time.perf_counter() - t, 1)
    print(f"[dryrun] phase (Y) took {time.perf_counter() - t0:.1f} s "
          f"({took} s)", flush=True)
    return launches


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
    t_start = time.perf_counter()
    print(_device_line(), flush=True)
    from repro_torch.graph.generators import grid_2d, rmat

    phase_build()
    _sync()
    phase_peaks()
    g = grid_2d(1024, 1024)
    kern = phase_kernels(g)
    _sync()
    chunk = phase_chunk_kernel(g)
    _sync()
    phase_parity()
    phase_parity_census()
    phase_parity_census10()
    phase_parity_gather()
    phase_parity_rowmajor()
    phase_parity_backends()
    _sync()
    by_path = {}
    by_path["u12_grid"], res_u12 = phase_full(g)
    _sync()
    by_path["u12_runner"] = phase_runner(g)
    _sync()
    by_path.update(phase_regimes(g))
    _sync()
    by_path["census10_grid"], batch_a, group_a, c_p, shapes_a, census = \
        phase_census_full(g)
    _sync()
    group = phase_group_kernel(g, batch_a, group_a)
    _sync()
    phase_bsr_census_kernel(g, batch_a, c_p)
    _sync()
    sweeps = {"census10_grid": phase_shape_sweep("census", g, 10, batch_a,
                                                 shapes_a)}
    _sync()
    t0 = time.perf_counter()
    g_rmat = rmat(20)
    print(f"[build] rmat(20) on the host: n={g_rmat.n} m={g_rmat.m} in "
          f"{time.perf_counter() - t0:.1f} s (outside the timed loops); "
          f"other operands would hold {layout_sizes(g_rmat)}", flush=True)
    by_path["u12_rmat20"], batch_b, shapes_b, est_b = \
        phase_gather_full(g_rmat)
    _sync()
    by_path["u12_rmat20_degree"] = phase_degree_rmat(g_rmat,
                                                     est_b["count"])
    _sync()
    by_path["u12_rmat20_defaults"] = phase_rmat_defaults(g_rmat, est_b,
                                                         batch_b)
    _sync()
    gather = phase_gather_kernel(g_rmat, batch_b)
    _sync()
    sweeps["u12_rmat20"] = phase_shape_sweep("path B", g_rmat, 12, batch_b,
                                             shapes_b)
    _sync()
    by_path["u13_chunked_grid"], est_u13 = phase_chunked_full(
        g, chunk[(torch.float32, 1716)])
    _sync()
    tuning = phase_autotune_kernels(g, g_rmat, batch_a, batch_b)
    _sync()
    for label, counts in phase_autotune_full(
            g, res_u12.estimate, census, est_u13).items():
        by_path[f"autotune_{label.replace(' ', '_')}"] = counts
    _sync()
    mesh = phase_reorder_mesh(g)
    for label, counts in mesh.items():
        by_path[f"u12_scrambled_{label}"] = counts
    _sync()
    phase_profile(g, g_rmat)
    _sync()
    del g_rmat
    by_path["distributed"], dist_rows = phase_distributed(g)
    for label, r in dist_rows.items():
        sweeps[f"distributed {label}"] = {label.split()[0]: r}
    _sync()
    by_path["service"] = phase_service(g, res_u12, est_u13)
    _sync()
    t_gnn = time.perf_counter()
    phase_gnn_parity()
    phase_gnn_example()
    by_path["gnn_motif_mesh"], gnn_sweeps = phase_gnn_full(g)
    sweeps.update(gnn_sweeps)
    print(f"[gnn] phase (G) took {time.perf_counter() - t_gnn:.1f} s",
          flush=True)
    t_lm = time.perf_counter()
    phase_lm_parity()
    phase_lm_blocks()
    phase_lm_consistency()
    by_path["lm_serve"] = phase_lm_serving()
    by_path["autoint_cells"] = phase_autoint_cells()
    print(f"[lm] phase (L) took {time.perf_counter() - t_lm:.1f} s",
          flush=True)
    by_path["train"], t1_peak = phase_train()
    by_path["dryrun"] = phase_dryrun(g, t1_peak)
    for path in ("lm_serve", "autoint_cells", "train"):
        if any(by_path[path].values()):
            raise AssertionError(f"{path} launched a counting kernel: "
                                 f"{by_path[path]}")
    # each kernel's numbers at the f32 shapes of the path it was added
    # for; its launches are those of that path's full run
    rows_of = {
        "spmm_bsr": ("u12_grid", kern[("spmm_bsr", torch.float32, 4)],
                     "src/repro_torch/csrc/spmm_bsr.cu",
                     "src/repro/kernels/spmm/pallas_bsr.py:59"),
        "ema": ("u12_grid", kern[("ema", torch.float32, 4)],
                "src/repro_torch/csrc/ema.cu",
                "src/repro/kernels/ema/pallas_ema.py:74"),
        "fused_spmm_ema": ("u12_grid",
                           kern[("fused_spmm_ema", torch.float32, 4)],
                           "src/repro_torch/csrc/fused_spmm_ema.cu",
                           "src/repro/kernels/fused/pallas_fused.py:143"),
        "fused_spmm_ema_shared": (
            "census10_grid", group[torch.float32],
            "src/repro_torch/csrc/fused_spmm_ema_shared.cu",
            "src/repro/kernels/fused/pallas_fused.py:305"),
        "spmm_gather": ("u12_rmat20", gather[(torch.float32, 12)],
                        "src/repro_torch/csrc/spmm_gather.cu",
                        "src/repro/kernels/spmm/pallas_gather.py:87"),
        # no Pallas kernel: the reference's chunked eMA is XLA
        # scatter-adds (ema_chunked's pair loop)
        "ema_chunk_acc": ("u13_chunked_grid", chunk[(torch.float32, 1716)],
                          "src/repro_torch/csrc/ema_chunk.cu",
                          "src/repro/kernels/ema/ops.py:193"),
    }
    rows = []
    for name, (path, m, source, rep) in rows_of.items():
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": rep, "launches": by_path[path][name],
                     "path": path,
                     "launches_by_path": {p: c[name]
                                          for p, c in by_path.items()},
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "bound_ms_measured": m["bound_ms_measured"],
                     "roof_fraction": m["roof_fraction"],
                     "library_ms": m["library_ms"],
                     "library_transposed_ms": m["library_transposed_ms"]})
        # the autotuner's launch shapes at this kernel's paths' shapes
        tuned = [{k: r[k] for k in ("shape", "default", "winner", "ms",
                                    "bound_ms_measured", "roof_fraction")}
                 for r in tuning if r["name"] == name]
        if tuned:
            rows[-1]["autotune"] = tuned
        # the costliest shape of the kernel on the other paths
        at = [dict(path=p, shape=r["shape"],
                   launches_per_batch=r["launches_per_batch"], ms=r["ms"],
                   bound_ms=r["bound_ms"],
                   bound_ms_measured=r["bound_ms_measured"],
                   roof_fraction=r["roof_fraction"], plain_ms=r["plain_ms"],
                   max_abs_err=r["max_abs_err"])
              for p, sw in sweeps.items() for k, r in sw.items() if k == name]
        if at:
            rows[-1]["at_paths"] = at
        if rows[-1]["launches"] == 0:
            raise AssertionError(f"{name} never launched on its path")
    print(f"[done] chip_smoke.py took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(f"[peaks] measured: {json.dumps(PEAKS)}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
