"""Crash-consistent JSON state: checksummed writes, quarantining loads.

The service persists three kinds of state — runner ledgers, the estimate
cache, metrics snapshots. A ``kill -9`` mid-write (or a torn NFS write, or
an injected ``corrupt`` fault) must never turn into an exception on the
*next* process's admission path. The contract here:

* :func:`write_checked` wraps the payload in a versioned envelope with a
  CRC32 over the canonical payload encoding and lands it via unique temp
  file + ``os.replace`` — a crashed writer can tear its temp file, never
  the live file;
* :func:`load_checked` verifies the envelope; a missing file is a clean
  cold start, while a truncated / garbage / checksum-failing file is
  **quarantined** — renamed to ``<path>.corrupt`` for post-mortem, counted
  in ``state_corruption_total{kind,reason}`` — and reported as a cold
  start. Pre-envelope files (a bare JSON dict from an older version) load
  as-is: the envelope is additive, not a migration.

Callers therefore always get *a* valid state dict; "rebuilt from scratch"
is the worst case, a crash is never one.

A copy of the JAX package's ``resilience/recovery.py``: the envelope and
the bytes :func:`write_checked` writes are the reference's, so a state
file written by either package loads as ``"ok"`` in the other.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import zlib

from repro_torch.obs import metrics as _metrics
from repro_torch.resilience import faults

__all__ = ["ENVELOPE_SCHEMA", "payload_crc", "write_checked",
           "load_checked", "quarantine"]

ENVELOPE_SCHEMA = 1


def payload_crc(payload) -> int:
    """CRC32 of the canonical (sorted-key, compact) JSON encoding."""
    body = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return zlib.crc32(body.encode())


def write_checked(path: str, payload: dict, *,
                  fault_point: str | None = None,
                  context: str = "") -> None:
    """Atomically replace ``path`` with the checksummed envelope of
    ``payload``. ``fault_point`` names the injection point whose ``raise``
    faults fire before the write and whose ``corrupt`` faults tear it."""
    if fault_point is not None:
        faults.inject(fault_point, context=context or path)
    body = json.dumps({"envelope": ENVELOPE_SCHEMA,
                       "crc": payload_crc(payload),
                       "payload": payload}).encode()
    if fault_point is not None:
        body = faults.corrupt_bytes(fault_point, body,
                                    context=context or path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(body)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def quarantine(path: str, *, kind: str, reason: str) -> str | None:
    """Move a corrupt state file to its ``.corrupt`` sidecar (post-mortem
    evidence, and the load path won't trip on it again); returns the
    sidecar path, or None when even the rename fails."""
    sidecar = path + ".corrupt"
    _metrics.counter("state_corruption_total", kind=kind,
                     reason=reason).inc()
    try:
        os.replace(path, sidecar)
    except OSError:
        with contextlib.suppress(OSError):
            os.unlink(path)
        return None
    return sidecar


def load_checked(path: str, *, kind: str,
                 fault_point: str | None = None) -> tuple[dict | None, str]:
    """Load a checksummed state file; returns ``(payload, status)``.

    Statuses: ``"ok"`` (payload verified — or legacy pre-envelope dict),
    ``"missing"`` (no file; payload None), or the corruption reason
    (``"json"`` / ``"schema"`` / ``"crc"`` / ``"io"``; payload None and
    the file has been quarantined). Never raises on bad state.
    """
    if not os.path.isfile(path):
        return None, "missing"
    try:
        if fault_point is not None:
            faults.inject(fault_point, context=path)
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8", errors="strict"))
    except json.JSONDecodeError:
        quarantine(path, kind=kind, reason="json")
        return None, "json"
    except Exception:
        # OSError and injected faults alike: an unreadable state file must
        # not raise into the caller; treat as corrupt and start cold
        quarantine(path, kind=kind, reason="io")
        return None, "io"
    if not isinstance(doc, dict):
        quarantine(path, kind=kind, reason="schema")
        return None, "schema"
    if "envelope" not in doc:
        return doc, "ok"                       # legacy pre-envelope state
    if doc.get("envelope") != ENVELOPE_SCHEMA or "payload" not in doc:
        quarantine(path, kind=kind, reason="schema")
        return None, "schema"
    if payload_crc(doc["payload"]) != doc.get("crc"):
        quarantine(path, kind=kind, reason="crc")
        return None, "crc"
    return doc["payload"], "ok"
