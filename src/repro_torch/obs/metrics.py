"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

One :class:`MetricsRegistry` per process (swap with :func:`set_registry`)
absorbs the stack's runtime accounting — cache hits, kernel fallbacks with
reasons, fusion admissions, dispatch counts, request latencies, memory-model
watermarks — so "what did the service actually do" is one snapshot away
instead of scattered ad-hoc attributes.

* **Counter** — monotonically increasing float (``inc``).
* **Gauge** — last-write-wins float (``set``).
* **Histogram** — fixed-bucket accumulation; p50/p95/p99 come from linear
  interpolation inside the winning bucket, so percentile error is bounded
  by the bucket width (the tests check this against numpy quantiles).

Metrics are identified by ``(name, sorted label pairs)``; the snapshot and
Prometheus forms render this as ``name{k="v",...}``. Export:

* :meth:`MetricsRegistry.snapshot` — a JSON-ready dict (schema versioned);
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text format
  (``*_bucket``/``*_sum``/``*_count`` series for histograms).
"""

from __future__ import annotations

import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_registry", "counter", "gauge", "histogram",
    "snapshot", "to_prometheus", "DEFAULT_TIME_BUCKETS", "SNAPSHOT_SCHEMA",
]

SNAPSHOT_SCHEMA = 1

# Log-spaced latency buckets (seconds): 10us .. 100s, {1, 2.5, 5} per decade.
DEFAULT_TIME_BUCKETS: tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(-5, 3) for m in (1.0, 2.5, 5.0))


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed upper-bound buckets (ascending, finite) plus an overflow slot."""

    __slots__ = ("le", "bucket_counts", "count", "sum")

    def __init__(self, buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS):
        le = tuple(float(b) for b in buckets)
        if not le or list(le) != sorted(le):
            raise ValueError("histogram buckets must be ascending and "
                             "non-empty")
        self.le = le
        self.bucket_counts = [0] * (len(le) + 1)   # last slot = overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        for i, ub in enumerate(self.le):
            if v <= ub:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Linear interpolation inside the bucket holding the q-quantile
        (0 <= q <= 1); error is bounded by that bucket's width."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.le):
            c = self.bucket_counts[i]
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lo + frac * (ub - lo)
            cum += c
            lo = ub
        return self.le[-1]    # overflow bucket: clamp to the last edge


def _fmt_key(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create metric instruments keyed by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted((str(k), str(v))
                                   for k, v in labels.items())))

    def counter(self, name: str, **labels) -> Counter:
        k = self._key(name, labels)
        c = self._counters.get(k)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(k, Counter())
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = self._key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(k, Gauge())
        return g

    def histogram(self, name: str, buckets: tuple[float, ...] | None = None,
                  **labels) -> Histogram:
        k = self._key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    k, Histogram(buckets or DEFAULT_TIME_BUCKETS))
        return h

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-ready dict of everything (schema-versioned; all values
        finite floats/ints, so ``json.dump`` round-trips losslessly)."""
        counters = {_fmt_key(*k): c.value
                    for k, c in sorted(self._counters.items())}
        gauges = {_fmt_key(*k): g.value
                  for k, g in sorted(self._gauges.items())}
        hists = {}
        for k, h in sorted(self._histograms.items()):
            hists[_fmt_key(*k)] = {
                "count": h.count, "sum": h.sum, "le": list(h.le),
                "bucket_counts": list(h.bucket_counts),
                "p50": h.percentile(0.50), "p95": h.percentile(0.95),
                "p99": h.percentile(0.99),
            }
        return {"schema": SNAPSHOT_SCHEMA, "counters": counters,
                "gauges": gauges, "histograms": hists}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        typed: set[str] = set()

        def type_line(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for (name, labels), c in sorted(self._counters.items()):
            type_line(name, "counter")
            lines.append(f"{_fmt_key(name, labels)} {c.value:g}")
        for (name, labels), g in sorted(self._gauges.items()):
            type_line(name, "gauge")
            lines.append(f"{_fmt_key(name, labels)} {g.value:g}")
        for (name, labels), h in sorted(self._histograms.items()):
            type_line(name, "histogram")
            cum = 0
            for ub, c in zip(h.le, h.bucket_counts):
                cum += c
                lbl = labels + (("le", f"{ub:g}"),)
                lines.append(f"{_fmt_key(name + '_bucket', lbl)} {cum}")
            lbl = labels + (("le", "+Inf"),)
            lines.append(f"{_fmt_key(name + '_bucket', lbl)} {h.count}")
            lines.append(f"{_fmt_key(name + '_sum', labels)} {h.sum:g}")
            lines.append(f"{_fmt_key(name + '_count', labels)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------- globals
_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def set_registry(r: MetricsRegistry) -> MetricsRegistry:
    global _registry
    _registry = r
    return r


def counter(name: str, **labels) -> Counter:
    return _registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _registry.gauge(name, **labels)


def histogram(name: str, buckets: tuple[float, ...] | None = None,
              **labels) -> Histogram:
    return _registry.histogram(name, buckets, **labels)


def snapshot() -> dict:
    return _registry.snapshot()


def to_prometheus() -> str:
    return _registry.to_prometheus()
