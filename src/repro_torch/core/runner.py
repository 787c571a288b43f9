"""Fault-tolerant color-coding estimator runner.

Color-coding iterations are independent, idempotent units of work (the
coloring is derived from fold_in(seed, iteration)), which makes the
fault-tolerance model simple and strong:

* a **ledger** (checksummed JSON, atomically replaced) records which
  iterations are done and the accumulated colorful sum;
* on restart, only missing iterations run — a preempted/failed run loses at
  most ``checkpoint_every`` iterations of work; a *torn* ledger (kill -9
  mid-write, disk corruption) is detected by its CRC envelope, quarantined
  to ``ledger.json.corrupt``, and the run restarts cold instead of raising
  into the scheduler;
* stragglers / lost pods: iterations are dispatched in batches; any worker
  can pick up remaining ones because nothing is owner-pinned;
* elastic scaling: the ledger is independent of the engine and device
  that wrote it, so a resumed run can use another engine, another card,
  or the JAX package's runner (the ledger's bytes are the reference's).

A copy of the JAX package's ``core/runner.py`` with the same ledger,
metric and span names; the distributed counter comes with distributed
counting (``ROADMAP.md``). Resume-equals-straight needs each iteration's
colorful sum to be bitwise independent of the batch it ran in, which the
port's engine keeps on the card (``CountingEngine``'s totals).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from repro_torch.core.colorsets import colorful_probability
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import recovery as _recovery

__all__ = ["EstimatorRunner", "RunnerResult", "engine_counter"]


@dataclasses.dataclass
class RunnerResult:
    count: float
    colorful_sum: float
    completed: list[int]
    elapsed_s: float
    restarts: int
    per_iteration: dict[int, float] = dataclasses.field(default_factory=dict)


class EstimatorRunner:
    """Drives ``n_iterations`` of any engine exposing per-iteration counting.

    ``counter(iterations: list[int]) -> dict[int, float]`` maps iteration ids
    to colorful sums; :func:`engine_counter` adapts a
    :class:`~repro_torch.core.engines.CountingEngine` to it.

    Two driving modes share the ledger:

    * **fixed budget** — :meth:`run` executes iterations ``0..n_iterations``;
    * **adaptive** — construct with ``n_iterations=None`` and call
      :meth:`run_iterations` with explicit iteration ids chosen round by
      round (the service scheduler's mode); already-ledgered ids are served
      from the ledger, so a killed run resumes without recomputation and the
      total iteration count can grow until a precision target is met.
    """

    def __init__(self, counter, *, k: int, automorphisms: int,
                 n_iterations: int | None, ledger_dir: str,
                 checkpoint_every: int = 8, seed: int = 0):
        self.counter = counter
        self.k = k
        self.alpha = automorphisms
        self.n_iterations = n_iterations
        self.ledger_dir = ledger_dir
        self.ledger_path = os.path.join(ledger_dir, "ledger.json")
        self.checkpoint_every = checkpoint_every
        self.seed = seed
        self._led: dict | None = None

    # ---------------------------------------------------------------- ledger
    def _load_ledger(self) -> dict:
        led, status = _recovery.load_checked(self.ledger_path, kind="ledger")
        if status not in ("ok", "missing"):
            _metrics.counter("runner_ledger_corruptions_total",
                             reason=status).inc()
        if led is not None and isinstance(led.get("completed"), dict) \
                and led.get("seed") == self.seed \
                and led.get("n_iterations") == self.n_iterations:
            return led
        return {"seed": self.seed, "n_iterations": self.n_iterations,
                "completed": {}, "restarts": 0}

    def _ledger(self) -> dict:
        """Ledger loaded once per runner instance; a non-empty ledger on
        first load means this instance is resuming a previous run."""
        if self._led is None:
            self._led = self._load_ledger()
            if self._led["completed"]:
                self._led["restarts"] = self._led.get("restarts", 0) + 1
                _metrics.counter("runner_resumes_total").inc()
                _metrics.counter("runner_resumed_iterations_total").inc(
                    len(self._led["completed"]))
        return self._led

    def _save_ledger(self, led: dict) -> None:
        os.makedirs(self.ledger_dir, exist_ok=True)
        _recovery.write_checked(self.ledger_path, led,
                                fault_point="ledger.write")

    def completed_iterations(self) -> dict[int, float]:
        """Ledgered {iteration id: colorful sum} — work already done."""
        led = self._ledger()
        return {int(k): float(v) for k, v in led["completed"].items()}

    # ------------------------------------------------------------------ run
    def run_iterations(self, iterations) -> dict[int, float]:
        """Run explicit iteration ids, checkpointing; -> {id: colorful sum}.

        Ids already in the ledger are returned without recomputation; fresh
        ones run through the counter in ``checkpoint_every`` batches (each a
        single device dispatch for batched engines), the ledger being
        atomically replaced after every batch.
        """
        led = self._ledger()
        done = {int(k): v for k, v in led["completed"].items()}
        ids = [int(i) for i in iterations]
        pending = [i for i in ids if i not in done]
        if len(pending) < len(ids):
            _metrics.counter("runner_ledger_served_iterations_total").inc(
                len(ids) - len(pending))
        for base in range(0, len(pending), self.checkpoint_every):
            batch = pending[base: base + self.checkpoint_every]
            with _tracing.span("runner.checkpoint", n=len(batch)):
                results = self.counter(batch)
            for it, val in results.items():
                done[int(it)] = float(val)
            led["completed"] = {str(k): v for k, v in done.items()}
            self._save_ledger(led)
            _metrics.counter("runner_checkpoints_total").inc()
            _metrics.counter("runner_iterations_total").inc(len(batch))
        return {i: done[i] for i in ids}

    def run(self, max_iterations_this_call: int | None = None) -> RunnerResult:
        if self.n_iterations is None:
            raise ValueError("run() needs a fixed n_iterations; "
                             "adaptive runners use run_iterations()")
        t0 = time.time()
        led = self._ledger()
        done = {int(k): v for k, v in led["completed"].items()}
        pending = [i for i in range(self.n_iterations) if i not in done]
        if max_iterations_this_call is not None:
            pending = pending[:max_iterations_this_call]

        for base in range(0, len(pending), self.checkpoint_every):
            batch = pending[base: base + self.checkpoint_every]
            with _tracing.span("runner.checkpoint", n=len(batch)):
                results = self.counter(batch)
            for it, val in results.items():
                done[int(it)] = float(val)
            led["completed"] = {str(k): v for k, v in done.items()}
            self._save_ledger(led)
            _metrics.counter("runner_checkpoints_total").inc()
            _metrics.counter("runner_iterations_total").inc(len(batch))

        total = float(np.sum(list(done.values()))) if done else 0.0
        n_done = len(done)
        p = colorful_probability(self.k)
        est = total / max(n_done, 1) / (self.alpha * p)
        return RunnerResult(
            count=est, colorful_sum=total,
            completed=sorted(done), elapsed_s=time.time() - t0,
            restarts=led.get("restarts", 0),
            per_iteration=dict(sorted(done.items())),
        )


def engine_counter(engine, seed: int = 0, batch_size: int | None = None,
                   label: str | None = None):
    """Adapt a CountingEngine to the runner's counter interface.

    A whole checkpoint batch runs through the engine's batched pipeline
    (colorings drawn on the device from ``fold_in(seed, iteration)``), one
    plan walk per ``batch_size`` ids; ``batch_size`` overrides the
    engine's budget-derived batch. Per-iteration values are independent of
    how iterations are grouped into batches, so resumed runs reproduce
    straight runs.

    ``label`` names this dispatch stream at the ``kernel.dispatch`` fault
    point (so chaos plans can target one group); defaults to the engine
    kind.
    """
    ctx = label if label is not None else getattr(engine, "engine", "engine")

    def counter(iterations):
        _faults.inject("kernel.dispatch", context=ctx)
        return engine.count_iterations_batch(list(iterations), seed=seed,
                                             batch_size=batch_size)

    return counter

