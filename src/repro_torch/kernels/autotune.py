"""Launch-shape autotuning for the CUDA kernels: a small cached sweep.

The port of the JAX package's ``kernels/autotune.py``. A plan walk
dispatches only a handful of distinct table shapes per engine, so timing
each candidate launch shape once per shape is cheap: every candidate is
launched once to warm, then timed over a few repetitions, and the winner is
cached in-process. Later dispatches of the same signature pay a dict
lookup; the ``autotune_cache_{hits,misses}_total`` counters (labelled
``kind``) make the reuse rate observable, and each sweep is one
``autotune.sweep`` span.

What is tuned is the launch shape each kernel takes at run time from a
few compiled instantiations (``csrc/``), its default first:

* the BSR SpMM (``kind="bsr"``): table rows a CUDA block takes,
  :data:`SPMM_C_BLOCK_CANDIDATES` (the reference's ``c_block``; 32 by
  default);
* the gather SpMM (``kind="gather"``): destinations a gather block holds,
  :data:`GATHER_BLOCK_CANDIDATES` (128 by default);
* the eMA: ``(s_block, n_block)``, the output rows and columns a CUDA
  block owns, :data:`EMA_BLOCK_CANDIDATES`. ``s_block`` 0 is the staged
  path, whose block owns every output row, at slices of ``n_block`` (16,
  32 or 64) columns; otherwise the direct path, ``s_block`` (4, 8 or 16)
  rows of 256 columns. The wrapper keeps the path it would take untuned
  and offers only that path's shapes.

The cache key is (kind, shapes, dtype names, device name, reorder): the
device name takes the place of the reference's ``interpret`` flag, so a
sweep on one card is never reused on another, and a bf16 sweep never
reuses f32 timings. The SpMM keys also carry the operand's shape (its
blocks and nonzeros, or its edges and hub segments): two graphs of one
vertex count do not share a winner.

Timing: on a CUDA device, CUDA events around each repetition after one
warm call, the median of ``reps``; anything else by ``time.perf_counter``
(so the machinery is tested on the CPU with stand-in callables).

Two deliberate departures from the reference:

* a candidate that cannot launch is removed before the sweep by the
  wrapper's own check (shared memory a block, grid limits, the table's
  rows), not discovered by a failed launch;
* a candidate that still fails raises: it is not skipped, and nothing is
  cached after a failure. A failed CUDA launch can leave the context
  unusable, and nothing may hide a kernel's failure.
"""

from __future__ import annotations

import functools
import statistics
import time
from typing import Callable, Hashable, Sequence

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing

__all__ = ["autotune", "ema_blocks", "spmm_c_block", "cache_info",
           "clear_cache", "device_name", "EMA_BLOCK_CANDIDATES",
           "SPMM_C_BLOCK_CANDIDATES", "GATHER_BLOCK_CANDIDATES"]

# (s_block, n_block) of the eMA kernel: the staged path's slice widths,
# then the direct path's output rows a block; each path's default first
EMA_BLOCK_CANDIDATES: tuple[tuple[int, int], ...] = (
    (0, 32), (0, 16), (0, 64), (8, 256), (4, 256), (16, 256),
)
# table rows a CUDA block of the BSR SpMM takes (csrc/spmm_bsr.cu)
SPMM_C_BLOCK_CANDIDATES: tuple[int, ...] = (32, 2, 4, 8, 16, 64)
# destinations a block of the gather SpMM holds (csrc/spmm_gather.cu)
GATHER_BLOCK_CANDIDATES: tuple[int, ...] = (128, 32, 64)

_CACHE: dict[Hashable, object] = {}


def clear_cache() -> None:
    _CACHE.clear()


def cache_info() -> dict:
    """Snapshot of tuned choices, by key (for benchmarks and debugging)."""
    return dict(_CACHE)


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_name(device) -> str:
    """The cache key's device: the card's name for a CUDA device (e.g.
    ``"NVIDIA H100 80GB HBM3"``), else the device's type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return _card_name(dev.index if dev.index is not None
                          else torch.cuda.current_device())
    return dev.type


def _time_once(fn: Callable[[], object], reps: int, device) -> float:
    """Median seconds of ``fn()`` over ``reps`` runs after one warm run."""
    dev = torch.device(device) if device is not None else None
    ts = []
    if dev is not None and dev.type == "cuda":
        fn()
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        fn()
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def autotune(key: Hashable, candidates: Sequence, make_fn: Callable,
             reps: int = 3, *, device=None):
    """The candidate minimizing the median time of ``make_fn(cand)()``.

    ``make_fn(cand)`` returns a zero-argument callable that runs the kernel
    with that launch shape; ``device`` says how to time it (CUDA events on
    a CUDA device). The winner is cached under ``key``; ties go to the
    earlier candidate. A candidate that raises ends the sweep with its
    exception and nothing is cached (see the module docstring)."""
    kind = str(key[0]) if isinstance(key, tuple) and key else "unknown"
    if key in _CACHE:
        _metrics.counter("autotune_cache_hits_total", kind=kind).inc()
        return _CACHE[key]
    if not candidates:
        raise ValueError(f"autotune {kind}: no candidate launch shape")
    _metrics.counter("autotune_cache_misses_total", kind=kind).inc()
    best, best_t = None, float("inf")
    with _tracing.span("autotune.sweep", kind=kind,
                       candidates=len(candidates)):
        for cand in candidates:
            t = _time_once(make_fn(cand), reps, device)
            if t < best_t:
                best, best_t = cand, t
    _CACHE[key] = best
    return best


def ema_blocks(m_a, y_p, ia, ip, *, out=None,
               candidates: Sequence[tuple[int, int]] = EMA_BLOCK_CANDIDATES
               ) -> tuple[int, int]:
    """Tuned ``(s_block, n_block)`` of the eMA kernel for these operands
    (CUDA tensors), among the ``candidates`` the wrapper can launch here
    (:func:`repro_torch.kernels.ema.ops.ema_shapes`). The sweep launches
    into ``out`` (the wrapper passes its own output), else into one it
    allocates. The eMA has no graph operand, so its key has no reorder."""
    from repro_torch.kernels.ema import ops as ema_ops
    cands = ema_ops.ema_shapes(m_a, y_p, ia, candidates)
    if out is None:
        out = ema_ops._empty_out(m_a, ia)
    key = ("ema", tuple(m_a.shape), tuple(y_p.shape), tuple(ia.shape),
           str(m_a.dtype), str(y_p.dtype), device_name(m_a.device))
    return autotune(key, cands,
                    lambda c: ema_ops.ema_sweep_launch(m_a, y_p, ia, ip, *c,
                                                       out),
                    device=m_a.device)


def spmm_c_block(m, run_with_c_block: Callable[[int], object], *,
                 kind: str, operand: tuple = (), reorder: str = "",
                 candidates: Sequence[int] = SPMM_C_BLOCK_CANDIDATES) -> int:
    """Tuned launch shape of an SpMM kernel (the name is the reference's):
    rows a CUDA block takes for ``kind="bsr"``, destinations a gather block
    holds for ``kind="gather"``. ``run_with_c_block(c)`` runs the kernel
    with that shape; ``candidates`` are the ones the wrapper can launch.
    The key is (kind, table shape, operand shape, dtype, device name,
    reorder): a winner for the RCM-reordered stream is a different entry
    than the identity order's."""
    key = (kind, tuple(m.shape), tuple(operand), str(m.dtype),
           device_name(m.device), reorder or "")
    return autotune(key, tuple(candidates),
                    lambda c: (lambda: run_with_c_block(c)),
                    device=m.device)
