"""Zero-dependency span tracer with a no-op fast path.

One process-wide :class:`Tracer` (swap it with :func:`set_tracer`) produces
nested, labeled :class:`Span`\\ s via the :func:`span` context manager::

    from repro_torch.obs import tracing
    with tracing.span("service.dispatch", group="u5", n=8):
        ...

Disabled (the default), :func:`span` returns one shared no-op context
manager — no allocation beyond the kwargs dict, no clock read — so hot
loops can be instrumented unconditionally.

Two timing refinements for kernel-launch instrumentation:

* ``sync=True`` makes :func:`sync_ready` call ``torch.cuda.synchronize``
  inside the enclosing span, so the span measures device time instead of
  launch time (torch is imported lazily; the tracer itself has no torch
  dependency).
* :func:`arm_profiler` arms a one-shot ``torch.profiler`` trace: the next
  :func:`profiled_dispatch` block writes a Chrome trace of the CPU and CUDA
  activity to the armed directory, then disarms — one dispatch, not the
  whole run.

Spans measure *host wall time of the code they wrap*. Kernel launches are
asynchronous, so the executor's per-node spans record launch time; device
time belongs to the span around the dispatch, with ``sync`` enabled.
"""

from __future__ import annotations

import contextlib
import threading
import time

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "configure", "span",
    "enabled", "sync_ready", "arm_profiler", "profiled_dispatch",
]


class Span:
    """One timed, labeled region; nested spans become children."""

    __slots__ = ("name", "attrs", "t0", "t1", "children", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        self.children: list[Span] = []

    @property
    def seconds(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (e.g. a result computed inside)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        self._tracer._pop(self)
        return False

    def to_dict(self) -> dict:
        return {"name": self.name, "seconds": self.seconds,
                "attrs": dict(self.attrs),
                "children": [c.to_dict() for c in self.children]}

    def __repr__(self) -> str:
        return f"Span({self.name}, {self.seconds * 1e3:.3f}ms, " \
               f"{len(self.children)} children)"


class _NullSpan:
    """Shared do-nothing span: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL = _NullSpan()


class Tracer:
    """Collects finished root spans; nesting follows a per-thread stack."""

    def __init__(self, enabled: bool = True, sync: bool = False,
                 max_roots: int = 10_000):
        self.enabled = bool(enabled)
        self.sync = bool(sync)
        self.max_roots = int(max_roots)
        self.roots: list[Span] = []
        self._local = threading.local()

    # ------------------------------------------------------------- plumbing
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, sp: Span) -> None:
        self._stack().append(sp)

    def _pop(self, sp: Span) -> None:
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        if st:
            st[-1].children.append(sp)
        elif len(self.roots) < self.max_roots:
            self.roots.append(sp)

    # ------------------------------------------------------------------ api
    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL
        return Span(self, name, attrs)

    def reset(self) -> None:
        self.roots = []
        self._local = threading.local()

    def to_dicts(self) -> list[dict]:
        return [r.to_dict() for r in self.roots]

    def breakdown(self) -> dict[str, dict]:
        """Aggregate ``{span name: {count, seconds}}`` over the whole tree."""
        agg: dict[str, dict] = {}

        def walk(sp: Span) -> None:
            ent = agg.setdefault(sp.name, {"count": 0, "seconds": 0.0})
            ent["count"] += 1
            ent["seconds"] += sp.seconds
            for c in sp.children:
                walk(c)

        for r in self.roots:
            walk(r)
        return agg


# ---------------------------------------------------------------- globals
_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(t: Tracer) -> Tracer:
    global _tracer
    _tracer = t
    return t


def configure(enabled: bool | None = None, sync: bool | None = None) -> Tracer:
    """Flip the process tracer's switches in place; returns it."""
    if enabled is not None:
        _tracer.enabled = bool(enabled)
    if sync is not None:
        _tracer.sync = bool(sync)
    return _tracer


def span(name: str, **attrs):
    """Context manager for one span on the process tracer (no-op when
    tracing is disabled — safe in hot loops)."""
    t = _tracer
    if not t.enabled:
        return _NULL
    return Span(t, name, attrs)


def enabled() -> bool:
    return _tracer.enabled


def sync_ready(x) -> None:
    """Wait for the device work behind tensor ``x`` inside the enclosing
    span iff the tracer asks for device-sync timing (``sync=True``);
    otherwise free. A CPU tensor has nothing to wait for."""
    if _tracer.enabled and _tracer.sync and getattr(x, "is_cuda", False):
        import torch
        torch.cuda.synchronize(x.device)


# ------------------------------------------------------- one-shot profiler
_profile_dir: list[str | None] = [None]


def arm_profiler(trace_dir: str | None) -> None:
    """Arm a one-shot ``torch.profiler`` trace: the next
    :func:`profiled_dispatch` block writes a Chrome trace to ``trace_dir``."""
    _profile_dir[0] = trace_dir


@contextlib.contextmanager
def profiled_dispatch():
    """Wrap one dispatch; writes a torch profiler trace if one is armed."""
    d = _profile_dir[0]
    if d is None:
        yield
        return
    _profile_dir[0] = None     # one-shot: disarm before running
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(d, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(d, "trace.json"))
