"""Degradation ladder and circuit breakers for the counting engines
(a copy of the JAX package's ``resilience/degradation.py``; the rungs are
the port's).

**Ladder.** A :class:`DegradationState` tracks, per engine-build identity
``(graph, template, engine, plan)``, how aggressive an execution config the
stack is allowed to use. Healthy groups run as requested (level
``as_built``). Repeated kernel/dispatch failures step the ladder *down*,
one reliability rung at a time, and the dispatch path rebuilds the engine
at the new level before retrying. The level names are the JAX package's,
so metric snapshots validate against one schema; in the port they mean:

=========  =============================================================
level 0     ``as_built`` — the requested build options, untouched (the
            port's engine fuses SpMM→eMA by default: the fused CUDA
            kernel and its shared-passive group form)
level 1     ``unfused`` — ``fuse_spmm_ema=False``: every node runs the
            SpMM kernel, then the eMA kernel; and no ``autotune_blocks``
            (each kernel at its default launch shape)
level 2     ``xla`` — also ``spmm_method="gather"`` (the edge-stream
            gather CUDA kernel instead of the BSR nonzero index), and f32
            storage where the build asked for bf16 or fp16
=========  =============================================================

Level 1 *sets* ``fuse_spmm_ema=False`` where the JAX package pops the
option: its engine's default is unfused, the port's is fused. Level 2 is
the JAX package's ``segment`` SpMM there; here every rung stays on
hand-written kernels, so a failing dispatch never gives way to a plain
PyTorch version on the card. A group that still fails at level 2 is left
to its circuit breaker.

Every transition is reason-labeled in ``degradation_steps_total{direction,
reason}`` and the current level published as ``degradation_level{engine,
template}``. After ``cooldown_s`` without a failure the ladder re-promotes
one level per dispatch (``direction="up"``), so a transient bad patch does
not permanently strand a group on the slow path.

**Circuit breaker.** A :class:`CircuitBreaker` per dispatch group
quarantines *poison* work: after ``threshold`` consecutive dispatch
failures (each already a full retry budget at the ladder's floor) the
circuit opens and further dispatches for that group fail fast — a
structured ``CircuitOpen`` error, no device work, no retry storm — while
every other group keeps serving. After ``cooldown_s`` the breaker goes
half-open and admits ONE trial dispatch: success closes it, failure
re-opens. ``circuit_open_total`` counts openings; :meth:`BreakerBoard.
snapshot` feeds ``/healthz`` so a load balancer can see a degraded-but-
alive process.
"""

from __future__ import annotations

import threading
import time

import torch

from repro_torch.obs import metrics as _metrics

__all__ = ["LADDER_LEVELS", "DegradationState", "CircuitOpen",
           "CircuitBreaker", "BreakerBoard"]

LADDER_LEVELS = ("as_built", "unfused", "xla")

_NARROW_DTYPES = ("bfloat16", "float16")


def _dtype_name(dt) -> str:
    """``bfloat16`` for ``torch.bfloat16`` and for the string alike."""
    return str(dt).rpartition(".")[2]


class DegradationState:
    """Per-engine-identity ladder position (see module docstring).

    ``label`` is the metric identity (``engine``/``template`` gauge
    labels); ``clock`` is injectable for cooldown tests.
    """

    def __init__(self, *, engine: str = "pgbsc", template: str = "",
                 step_after: int = 2, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.engine = engine
        self.template = template
        self.step_after = max(int(step_after), 1)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.level = 0
        self._consecutive = 0
        self._last_failure = None
        self._lock = threading.Lock()
        self._publish()

    @property
    def level_name(self) -> str:
        return LADDER_LEVELS[self.level]

    def _publish(self) -> None:
        _metrics.gauge("degradation_level", engine=self.engine,
                       template=self.template).set(self.level)

    def on_failure(self, reason: str = "dispatch_error") -> bool:
        """Record one failed attempt; returns True when the ladder stepped
        down (the caller should rebuild the engine at :meth:`apply`)."""
        with self._lock:
            self._consecutive += 1
            self._last_failure = self.clock()
            if (self._consecutive % self.step_after == 0
                    and self.level < len(LADDER_LEVELS) - 1):
                self.level += 1
                _metrics.counter("degradation_steps_total",
                                 direction="down", reason=reason).inc()
                self._publish()
                return True
        return False

    def on_success(self) -> None:
        with self._lock:
            self._consecutive = 0

    def maybe_promote(self) -> bool:
        """Step up one level if degraded and the cooldown elapsed since the
        last failure; returns True when promoted (engine rebuild due)."""
        with self._lock:
            if self.level == 0 or self._last_failure is None:
                return False
            if self.clock() - self._last_failure < self.cooldown_s:
                return False
            self.level -= 1
            self._last_failure = self.clock()   # one rung per cooldown
            _metrics.counter("degradation_steps_total",
                             direction="up", reason="cooldown").inc()
            self._publish()
            return True

    def apply(self, engine_kw: dict) -> dict:
        """The build options for the current level: ``engine_kw`` with the
        unreliable features stripped. Level 0 returns a copy unchanged."""
        kw = dict(engine_kw)
        if self.level >= 1:
            kw["fuse_spmm_ema"] = False
            kw.pop("autotune_blocks", None)
        if self.level >= 2:
            kw["spmm_method"] = "gather"
            dt = kw.get("dtype")
            if dt is not None and _dtype_name(dt) in _NARROW_DTYPES:
                kw["dtype"] = torch.float32
        return kw

    def snapshot(self) -> dict:
        return {"level": self.level, "level_name": self.level_name,
                "consecutive_failures": self._consecutive}


class CircuitOpen(RuntimeError):
    """Dispatch refused: the group's circuit breaker is open (poison
    quarantine). Carries the group label for structured error bodies."""

    def __init__(self, label: str, failures: int):
        self.label = label
        self.failures = failures
        super().__init__(
            f"circuit open for group {label} after {failures} consecutive "
            f"dispatch failures; retry after cool-down")


class CircuitBreaker:
    """closed → (threshold consecutive failures) → open → (cooldown) →
    half-open → one trial → closed | open."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 label: str = "", clock=time.monotonic):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self.label = label
        self.clock = clock
        self.state = self.CLOSED
        self.failures = 0          # consecutive
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May the caller dispatch now? An open breaker past its cooldown
        transitions to half-open and admits exactly one trial."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.HALF_OPEN:
                return False           # a trial is already in flight
            if self.clock() - self._opened_at >= self.cooldown_s:
                self.state = self.HALF_OPEN
                return True
            return False

    def on_success(self) -> None:
        with self._lock:
            self.state = self.CLOSED
            self.failures = 0

    def on_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == self.HALF_OPEN or \
                    self.failures >= self.threshold:
                if self.state != self.OPEN:
                    _metrics.counter("circuit_open_total").inc()
                self.state = self.OPEN
                self._opened_at = self.clock()

    def snapshot(self) -> dict:
        return {"state": self.state, "consecutive_failures": self.failures}


class BreakerBoard:
    """All of one service's breakers, keyed by dispatch-group key."""

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._breakers: dict = {}
        self._lock = threading.Lock()

    def get(self, key, label: str = "") -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(threshold=self.threshold,
                                    cooldown_s=self.cooldown_s,
                                    label=label or str(key),
                                    clock=self.clock)
                self._breakers[key] = br
            return br

    def snapshot(self) -> dict:
        """State counts plus the non-closed breakers by label (healthz)."""
        with self._lock:
            counts = {CircuitBreaker.CLOSED: 0, CircuitBreaker.OPEN: 0,
                      CircuitBreaker.HALF_OPEN: 0}
            unhealthy = {}
            for br in self._breakers.values():
                counts[br.state] += 1
                if br.state != CircuitBreaker.CLOSED:
                    unhealthy[br.label] = br.snapshot()
            return {"counts": counts, "unhealthy": unhealthy}
