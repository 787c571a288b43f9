"""Seed-deterministic fault-injection harness for the counting stack.

Every layer of the stack exposes **named injection points** — places where
production code asks the process-wide :class:`FaultPlan` "should something
go wrong here, now?". With no plan installed the question costs one global
read and a ``None`` check; with a plan installed, each point draws from its
own seeded random stream, so a given ``(plan seed, point, hit index)``
always fires (or not) identically — chaos runs are reproducible.

Named points (the ``point`` label of ``fault_injections_total``):

=================  =====================================================
``kernel.dispatch``  the engine's batched device dispatch (counter call)
``engine.build``     engine construction inside the :class:`EngineCache`
``ledger.write``     the runner's checkpoint write (corruptible)
``cache.read``       persistent estimate-cache file read (corruptible)
``http.handler``     the HTTP front end's request handlers
``dispatch.hang``    start of a dispatch attempt (hang → watchdog)
``dispatch.loop``    top of the async dispatcher loop (supervisor test)
=================  =====================================================

Fault modes:

* ``raise`` — raise :class:`InjectedFault` (an ordinary ``RuntimeError``
  subclass: containment code must treat it like any crash);
* ``delay`` — sleep ``delay_s`` then continue (latency, not failure);
* ``hang`` — sleep ``hang_s`` (default 300 s — far past any watchdog);
* ``corrupt`` — only at write/read points that call :func:`corrupt_bytes`:
  truncate the payload at a deterministic offset, simulating a torn write
  (``kill -9`` mid-``write``).

A spec fires with probability ``rate`` per hit, after skipping the first
``after`` hits, at most ``times`` times, and only when ``match`` (a
substring) occurs in the injection context label — so a test can poison
exactly one dispatch group while the rest of the workload runs clean.

Install a plan process-wide with :func:`install_plan` (the ``serve
--inject`` path), or scoped with :func:`active_plan` (the test fixture
path). Compact spec-string form, for the CLI::

    kernel.dispatch:raise:0.1,ledger.write:corrupt:0.05,dispatch.hang:hang:0.02

A copy of the JAX package's ``resilience/faults.py`` (the same points,
modes, streams and truncation offsets, so a chaos plan fires identically
in both packages). The port's runner hits ``kernel.dispatch`` and
``ledger.write``; the other points belong to the service stack, which is
not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import threading
import time

from repro_torch.obs import metrics as _metrics

__all__ = [
    "POINTS", "MODES", "InjectedFault", "FaultSpec", "FaultPlan",
    "install_plan", "clear_plan", "current_plan", "active_plan",
    "inject", "corrupt_bytes",
]

POINTS = frozenset((
    "kernel.dispatch", "engine.build", "ledger.write", "cache.read",
    "http.handler", "dispatch.hang", "dispatch.loop",
))

MODES = frozenset(("raise", "delay", "hang", "corrupt"))


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-mode fault. Deliberately a plain RuntimeError
    subclass: containment paths must handle it exactly like a real crash —
    code that special-cases InjectedFault is cheating the chaos suite."""

    def __init__(self, point: str, context: str = ""):
        self.point = point
        self.context = context
        super().__init__(f"injected fault at {point}"
                         + (f" ({context})" if context else ""))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault class at one injection point."""

    point: str
    mode: str = "raise"
    rate: float = 1.0          # firing probability per (matched) hit
    times: int | None = None   # total firing budget (None = unlimited)
    after: int = 0             # skip the first N matched hits
    match: str = ""            # substring filter on the context label
    delay_s: float = 0.05      # sleep for mode="delay"
    hang_s: float = 300.0      # sleep for mode="hang"

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown injection point {self.point!r}; "
                             f"known: {sorted(POINTS)}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"known: {sorted(MODES)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


class FaultPlan:
    """A set of :class:`FaultSpec`\\ s with seed-deterministic firing.

    Each spec owns an independent ``random.Random`` stream seeded from
    ``(plan seed, point, spec index)`` plus hit counters, so the firing
    pattern is a pure function of the plan seed and the sequence of hits
    at each point — identical workloads see identical faults.
    """

    def __init__(self, specs, seed: int = 0):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._lock = threading.Lock()
        self._rngs = [random.Random(f"{self.seed}:{s.point}:{i}")
                      for i, s in enumerate(self.specs)]
        self._hits = [0] * len(self.specs)     # matched hits per spec
        self._fired = [0] * len(self.specs)    # firings per spec

    # ------------------------------------------------------------- parsing
    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """``point:mode[:rate[:times]]`` specs, comma-separated; or a path
        to a JSON file (``{"seed": .., "faults": [{...}, ...]}``)."""
        text = text.strip()
        if os.path.isfile(text):
            with open(text) as f:
                doc = json.load(f)
            return cls([FaultSpec(**s) for s in doc.get("faults", [])],
                       seed=doc.get("seed", seed))
        specs = []
        for part in filter(None, (p.strip() for p in text.split(","))):
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(f"fault spec {part!r}: want "
                                 "point:mode[:rate[:times]]")
            kw: dict = {"point": fields[0], "mode": fields[1]}
            if len(fields) > 2:
                kw["rate"] = float(fields[2])
            if len(fields) > 3:
                kw["times"] = int(fields[3])
            specs.append(FaultSpec(**kw))
        return cls(specs, seed=seed)

    # -------------------------------------------------------------- firing
    def _armed(self, point: str, context: str, modes) -> FaultSpec | None:
        """The first spec that fires for this hit (advances counters)."""
        with self._lock:
            for i, s in enumerate(self.specs):
                if s.point != point or s.mode not in modes:
                    continue
                if s.match and s.match not in context:
                    continue
                self._hits[i] += 1
                if self._hits[i] <= s.after:
                    continue
                if s.times is not None and self._fired[i] >= s.times:
                    continue
                if self._rngs[i].random() >= s.rate:
                    continue
                self._fired[i] += 1
                return s
        return None

    def stats(self) -> dict:
        """Per-spec hit/fire counts (tests, /healthz)."""
        with self._lock:
            return {f"{s.point}:{s.mode}": {"hits": h, "fired": f}
                    for s, h, f in zip(self.specs, self._hits, self._fired)}


# ------------------------------------------------------------- process plan
_plan: FaultPlan | None = None


def install_plan(plan: FaultPlan | None) -> FaultPlan | None:
    """Install (or, with None, remove) the process-wide fault plan."""
    global _plan
    _plan = plan
    return plan


def clear_plan() -> None:
    install_plan(None)


def current_plan() -> FaultPlan | None:
    return _plan


@contextlib.contextmanager
def active_plan(plan: FaultPlan):
    """Scoped installation (the chaos-test fixture path)."""
    prev = current_plan()
    install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(prev)


def _record(spec: FaultSpec) -> None:
    _metrics.counter("fault_injections_total", point=spec.point,
                     mode=spec.mode).inc()


def inject(point: str, context: str = "") -> None:
    """Ask the installed plan whether a raise/delay/hang fault fires here.

    No-op without a plan (one global read). ``context`` is a free-form
    label (group key, engine name, request id) that specs can ``match``
    against and that travels in the raised error message.
    """
    plan = _plan
    if plan is None:
        return
    spec = plan._armed(point, context, ("raise", "delay", "hang"))
    if spec is None:
        return
    _record(spec)
    if spec.mode == "delay":
        time.sleep(spec.delay_s)
        return
    if spec.mode == "hang":
        time.sleep(spec.hang_s)
        return
    raise InjectedFault(point, context)


def corrupt_bytes(point: str, payload: bytes, context: str = "") -> bytes:
    """Possibly truncate ``payload`` — a torn write at a corruptible point.

    The truncation offset is deterministic in the spec's stream. An empty
    or one-byte payload passes through (nothing to tear).
    """
    plan = _plan
    if plan is None or len(payload) < 2:
        return payload
    spec = plan._armed(point, context, ("corrupt",))
    if spec is None:
        return payload
    _record(spec)
    cut = 1 + (zhash(point, plan.seed) % (len(payload) - 1))
    return payload[:cut]


def zhash(text: str, seed: int) -> int:
    """Small stable hash (process-hash-randomization-proof)."""
    h = 2166136261 ^ seed
    for ch in text.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h
