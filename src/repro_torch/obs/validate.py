"""Schema validation for :meth:`MetricsRegistry.snapshot` JSON files (a
copy of the JAX package's ``obs/validate.py``; both packages write the
same schema, so each validates the other's snapshots).

Library: :func:`validate_snapshot` raises ``ValueError`` with a pointed
message on the first violation. CLI (the CI obs-smoke step)::

    python -m repro_torch.obs.validate SNAPSHOT.json \\
        --require-nonzero fusion --require-nonzero cache \\
        --require-hist 'qos='

``--require-nonzero PREFIX`` additionally demands at least one counter
whose name starts with (or contains) ``PREFIX`` with a nonzero value —
the smoke check that the instrumented paths actually ran.
``--require-hist PREFIX`` does the same for histograms (at least one
matching histogram with ``count > 0``), e.g. the per-QoS-class latency
histograms the serving smoke asserts on.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from repro_torch.obs.metrics import SNAPSHOT_SCHEMA

__all__ = ["validate_snapshot", "main"]

_HIST_KEYS = {"count", "sum", "le", "bucket_counts", "p50", "p95", "p99"}


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


def validate_snapshot(snap: object) -> dict:
    """Validate a snapshot dict; returns it (for chaining) or raises
    ``ValueError`` describing the first problem found."""
    if not isinstance(snap, dict):
        raise ValueError(f"snapshot must be a dict, got {type(snap).__name__}")
    if snap.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"snapshot schema {snap.get('schema')!r} != "
                         f"expected {SNAPSHOT_SCHEMA}")
    for sect in ("counters", "gauges", "histograms"):
        if not isinstance(snap.get(sect), dict):
            raise ValueError(f"snapshot[{sect!r}] must be a dict")
    for sect in ("counters", "gauges"):
        for k, v in snap[sect].items():
            if not isinstance(k, str) or not _num(v):
                raise ValueError(f"{sect}[{k!r}] = {v!r}: want finite number")
    for k, h in snap["histograms"].items():
        if not isinstance(h, dict) or not _HIST_KEYS <= set(h):
            raise ValueError(f"histograms[{k!r}] missing keys "
                             f"{sorted(_HIST_KEYS - set(h or {}))}")
        le = h["le"]
        if (not isinstance(le, list) or not le
                or any(not _num(b) for b in le) or le != sorted(le)):
            raise ValueError(f"histograms[{k!r}].le must be ascending finite "
                             "numbers")
        bc = h["bucket_counts"]
        if not isinstance(bc, list) or len(bc) != len(le) + 1 \
                or any(not isinstance(c, int) or c < 0 for c in bc):
            raise ValueError(f"histograms[{k!r}].bucket_counts must be "
                             f"{len(le) + 1} non-negative ints")
        if not isinstance(h["count"], int) or sum(bc) != h["count"]:
            raise ValueError(f"histograms[{k!r}]: bucket_counts sum "
                             f"{sum(bc)} != count {h['count']!r}")
        if not _num(h["sum"]) or any(not _num(h[p])
                                     for p in ("p50", "p95", "p99")):
            raise ValueError(f"histograms[{k!r}]: sum/percentiles must be "
                             "finite numbers")
    return snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("snapshot", help="path to a MetricsRegistry.snapshot() "
                                     "JSON file")
    ap.add_argument("--require-nonzero", action="append", default=[],
                    metavar="PREFIX",
                    help="demand >=1 nonzero counter whose key contains "
                         "PREFIX (repeatable)")
    ap.add_argument("--require-hist", action="append", default=[],
                    metavar="PREFIX",
                    help="demand >=1 histogram whose key contains PREFIX "
                         "with count > 0 (repeatable)")
    args = ap.parse_args(argv)
    with open(args.snapshot) as f:
        snap = json.load(f)
    validate_snapshot(snap)
    for prefix in args.require_nonzero:
        hits = {k: v for k, v in snap["counters"].items()
                if prefix in k and v > 0}
        if not hits:
            print(f"FAIL: no nonzero counter matching {prefix!r}",
                  file=sys.stderr)
            return 1
        print(f"ok: {prefix!r} -> {len(hits)} nonzero counter(s), e.g. "
              f"{next(iter(hits))}")
    for prefix in args.require_hist:
        hits = {k: h for k, h in snap["histograms"].items()
                if prefix in k and h["count"] > 0}
        if not hits:
            print(f"FAIL: no populated histogram matching {prefix!r}",
                  file=sys.stderr)
            return 1
        print(f"ok: {prefix!r} -> {len(hits)} populated histogram(s), e.g. "
              f"{next(iter(hits))}")
    n = (len(snap["counters"]), len(snap["gauges"]), len(snap["histograms"]))
    print(f"valid snapshot: {n[0]} counters, {n[1]} gauges, "
          f"{n[2]} histograms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
