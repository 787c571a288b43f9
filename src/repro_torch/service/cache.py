"""Engine/plan and estimate caches for the counting service (a copy of
the JAX package's ``service/cache.py`` over the port's engines).

Engine builds are the expensive fixed cost of a request: SpMM preparation
walks the whole edge set and copies the operand to the card. The
:class:`EngineCache` keys built engines by
``(graph fingerprint, template canonical hash, engine, plan, build
options)`` — the device among the options, so a CPU engine and a CUDA
engine never alias — so repeated and concurrent requests never rebuild —
*content* hashes on both axes: the graph's ``Graph.fingerprint`` and the
template's ``canonical_hash``, so two differently-named registrations of
the same graph AND two spellings of the same tree (registry name vs. raw
edge list, relabeled vertices) still share one engine. A list of same-k
templates keys a fused multi-template engine the same way (joined hashes).

The :class:`EstimateCache` persists *answers* (estimate, stderr, iteration
count) keyed by the same identity plus the coloring seed, as a JSON file
that is atomically replaced on update. A new service process can serve a
repeat query straight from it — without even building an engine — whenever
the cached precision already meets the request's target. The file carries
a ``schema`` version: entries written before the canonical-hash keying
(version < 2 keyed by template *names*) are ignored on load — never
crashed on — so a stale name key can't alias a canonical-hash key. The
key string and the file schema are the JAX package's (``Graph.fingerprint``
is equal across the packages), so a results file written by either
package serves the other.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
from collections import OrderedDict

try:                              # POSIX advisory file lock; absent on
    import fcntl                  # platforms where flock is unavailable
except ImportError:               # (the cache degrades to atomic-replace-
    fcntl = None                  # only, which is still torn-write-safe)

import torch

from repro_torch.core.engines import CountingEngine, build_engine
from repro_torch.core.templates import TemplateSpec, as_template
from repro_torch.graph.structure import Graph
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing
from repro_torch.resilience import faults as _faults
from repro_torch.resilience import recovery as _recovery

__all__ = ["EngineCache", "EstimateCache", "SCHEMA_VERSION"]


DEFAULT_MAX_ENTRIES = 8

# estimate-cache file schema; bumped when key semantics change (v2: keys
# carry template canonical hashes instead of registry names)
SCHEMA_VERSION = 2


def _template_key(template) -> str:
    """Canonical-hash key component for one template or a fused bundle."""
    if isinstance(template, (list, tuple)):
        return "+".join(TemplateSpec.of(t).canonical_hash for t in template)
    return TemplateSpec.of(template).canonical_hash


def _template_build_arg(template):
    """What build_engine receives: TreeTemplate(s), warm caches preserved."""
    if isinstance(template, (list, tuple)):
        return [as_template(t) for t in template]
    return as_template(template)


class EngineCache:
    """LRU cache of built :class:`CountingEngine` instances.

    ``max_entries`` bounds resident engines — each holds its device-side
    graph operand (2.57 GB for ``grid_2d(1024, 1024)``'s BSR operand), so
    an unbounded cache is an unbounded device-memory leak under
    multi-tenant traffic. The default keeps 8; pass ``None`` explicitly for
    the unbounded behavior. Eviction calls the engine's
    :meth:`~repro_torch.core.engines.CountingEngine.release`, which drops
    its device tensors back to torch's caching allocator (an evicted engine
    that a caller still holds rebuilds lazily on next use).
    ``hits`` / ``misses`` count lookups, ``builds`` counts constructions,
    ``evictions`` counts released engines — the service surfaces these so
    "no second engine build" and "bounded residency" are both observable.
    """

    def __init__(self, max_entries: int | None = DEFAULT_MAX_ENTRIES):
        self.max_entries = max_entries
        self._engines: OrderedDict[tuple, CountingEngine] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.evictions = 0

    @staticmethod
    def key(g: Graph, template, engine: str, plan: str,
            **build_kw) -> tuple:
        # None-valued options mean "engine default" and must alias the
        # absent spelling (reorder=None == no reorder kwarg); values key by
        # name (torch dtypes as "torch.float32"). The device is always part
        # of the key, absent or None meaning the engine default, CUDA.
        device = str(torch.device(build_kw.pop("device", None) or "cuda"))
        opts = tuple(sorted(
            (k, getattr(v, "__name__", None) or str(v))
            for k, v in build_kw.items() if v is not None))
        return (g.fingerprint, _template_key(template), engine, plan,
                (("device", device), *opts))

    def get(self, g: Graph, template, engine: str = "pgbsc",
            plan: str = "optimized", **build_kw) -> CountingEngine:
        """``template``: name / TemplateSpec / TreeTemplate / edge list, or
        a list of them (equal k) for a fused multi-template engine."""
        k = self.key(g, template, engine, plan, **build_kw)
        if k in self._engines:
            self.hits += 1
            _metrics.counter("engine_cache_lookups_total",
                             result="hit").inc()
            self._engines.move_to_end(k)
            return self._engines[k]
        self.misses += 1
        _metrics.counter("engine_cache_lookups_total", result="miss").inc()
        _faults.inject("engine.build",
                       context=f"{g.fingerprint[:12]}:{engine}:{plan}")
        with _tracing.span("engine_cache.build", engine=engine, plan=plan):
            eng = build_engine(g, _template_build_arg(template), engine,
                               plan=plan, **build_kw)
        self.builds += 1
        _metrics.counter("engine_cache_builds_total").inc()
        self._engines[k] = eng
        if self.max_entries is not None:
            while len(self._engines) > self.max_entries:
                _, old = self._engines.popitem(last=False)
                if hasattr(old, "release"):
                    old.release()
                self.evictions += 1
                _metrics.counter("engine_cache_evictions_total").inc()
        return eng

    def has(self, g: Graph, template, engine: str = "pgbsc",
            plan: str = "optimized", **build_kw) -> bool:
        """Whether this exact engine is cache-resident — a pure probe: no
        build, no LRU refresh (the async warm pool uses it to decide what
        to pre-materialize without perturbing eviction order)."""
        return self.key(g, template, engine, plan, **build_kw) \
            in self._engines

    def resident_ids(self) -> set[int]:
        """``id()`` of cache-managed engine objects — the set whose device
        residency ``max_entries`` bounds (used by the service to avoid
        releasing engines that are still cache-warm)."""
        return {id(e) for e in self._engines.values()}

    def __len__(self) -> int:
        return len(self._engines)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "builds": self.builds, "evictions": self.evictions,
                "resident": len(self._engines)}


class EstimateCache:
    """Persistent map from request identity to a finished estimate.

    Entries: ``{estimate, stderr, rel_stderr, iterations}``. ``path=None``
    keeps the cache in-memory (tests / ephemeral services). The on-disk
    form is ``{"schema": SCHEMA_VERSION, "crc": ..., "entries": {...}}``;
    files with a different (or missing — pre-versioning) schema are
    silently treated as empty, because their keys used template *names*
    and must not alias today's canonical-hash keys. Unparseable or
    CRC-failing files (torn writes, disk corruption) are quarantined to a
    ``.corrupt`` sidecar and the cache starts cold — see
    :mod:`repro_torch.resilience.recovery`.

    **Concurrency.** The cache is safe for concurrent writers — both the
    async front end's threads inside one process and independent service
    processes sharing one file:

    * every write goes to a uniquely-named temp file in the target
      directory and lands via ``os.replace`` — a crashed or preempted
      writer can tear its temp file, never the cache;
    * the whole read-modify-write is serialized under an exclusive
      ``flock`` on a ``<path>.lock`` sidecar (plus an in-process mutex),
      and *merges* with the entries on disk before replacing — two
      processes writing disjoint keys both survive, and for a contended
      key the entry with more iterations wins (the same
      keep-the-tighter-answer policy the scheduler applies).
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._mem: dict[str, dict] = {}
        self._tlock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.invalidations = 0
        if path:
            with self._file_lock():
                self._mem = self._read_disk()

    # ------------------------------------------------------- file locking
    @contextlib.contextmanager
    def _file_lock(self):
        """Exclusive advisory lock on ``<path>.lock`` (no-op when the cache
        is memory-only or flock is unavailable)."""
        if not self.path or fcntl is None:
            yield
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path + ".lock", "a+") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def _read_disk(self) -> dict[str, dict]:
        """Entries currently on disk (empty on stale schema / unreadable /
        missing / torn file — discarded, never crashed on).

        A file that fails to parse or fails its CRC — a ``kill -9``
        mid-write predating the tmp+replace protocol, disk corruption, an
        injected ``cache.read`` fault — is quarantined to a ``.corrupt``
        sidecar and the cache continues cold: corruption must never raise
        into the admission path."""
        if not self.path or not os.path.isfile(self.path):
            return {}
        try:
            _faults.inject("cache.read", context=self.path)
            with open(self.path) as f:
                data = json.load(f)
        except Exception:
            _recovery.quarantine(self.path, kind="estimate_cache",
                                 reason="read")
            self.invalidations += 1
            _metrics.counter("estimate_cache_invalidations_total",
                             reason="corrupt").inc()
            return {}
        if (isinstance(data, dict)
                and data.get("schema") == SCHEMA_VERSION
                and isinstance(data.get("entries"), dict)):
            if "crc" in data and \
                    _recovery.payload_crc(data["entries"]) != data["crc"]:
                _recovery.quarantine(self.path, kind="estimate_cache",
                                     reason="crc")
                self.invalidations += 1
                _metrics.counter("estimate_cache_invalidations_total",
                                 reason="corrupt").inc()
                return {}
            return data["entries"]
        self.invalidations += 1
        _metrics.counter("estimate_cache_invalidations_total",
                         reason="schema").inc()
        return {}

    @staticmethod
    def _merge(into: dict[str, dict], new: dict[str, dict]) -> dict:
        """Overlay ``new`` on ``into``; on key conflict the entry with more
        iterations wins (ties keep ``new``)."""
        for k, ent in new.items():
            prev = into.get(k)
            if prev is None or prev.get("iterations", 0) <= \
                    ent.get("iterations", 0):
                into[k] = ent
        return into

    @staticmethod
    def key(graph_fingerprint: str, template, engine: str, plan: str,
            seed: int) -> str:
        """``template`` may be anything :meth:`TemplateSpec.of` accepts;
        the key always carries its canonical hash."""
        th = _template_key(template)
        return f"{graph_fingerprint}:{th}:{engine}:{plan}:s{seed}"

    def get(self, key: str) -> dict | None:
        return self._mem.get(key)

    def satisfies(self, key: str, rel_stderr: float | None,
                  max_iters: int | None, min_iters: int = 0) -> dict | None:
        """The cached entry, if it already meets the request's precision
        contract (at least as tight a rel stderr AND at least ``min_iters``
        samples — the same early-stop guard the scheduler enforces; at
        least as many iterations as a pure iteration-cap request would
        run)."""
        ent = self._satisfies(key, rel_stderr, max_iters, min_iters)
        if ent is None:
            self.misses += 1
            _metrics.counter("estimate_cache_lookups_total",
                             result="miss").inc()
        else:
            self.hits += 1
            _metrics.counter("estimate_cache_lookups_total",
                             result="hit").inc()
        return ent

    def _satisfies(self, key, rel_stderr, max_iters, min_iters):
        ent = self._mem.get(key)
        if ent is None:
            return None
        if rel_stderr is not None:
            ok = (ent["rel_stderr"] <= rel_stderr
                  and ent["iterations"] >= min_iters)
            return ent if ok else None
        return ent if ent["iterations"] >= (max_iters or 0) else None

    def put(self, key: str, entry: dict) -> None:
        with self._tlock:
            self._merge(self._mem, {key: entry})
            self.writes += 1
            _metrics.counter("estimate_cache_writes_total").inc()
            if not self.path:
                return
            with self._file_lock():
                # merge with what concurrent writers already landed, so
                # interleaved puts from other threads/processes are never
                # lost — then replace atomically via a unique temp file
                self._mem = self._merge(self._read_disk(), self._mem)
                d = os.path.dirname(self.path) or "."
                os.makedirs(d, exist_ok=True)
                fd, tmp = tempfile.mkstemp(
                    dir=d, prefix=os.path.basename(self.path) + ".")
                try:
                    with os.fdopen(fd, "w") as f:
                        json.dump({"schema": SCHEMA_VERSION,
                                   "crc": _recovery.payload_crc(self._mem),
                                   "entries": self._mem}, f)
                    os.replace(tmp, self.path)
                except BaseException:
                    with contextlib.suppress(OSError):
                        os.unlink(tmp)
                    raise

    def __len__(self) -> int:
        return len(self._mem)

    def stats(self) -> dict:
        """Same contract as :meth:`EngineCache.stats`: lookup hits/misses
        (``satisfies`` calls — the serve-from-cache decision point),
        writes, schema invalidations, and resident entry count."""
        return {"hits": self.hits, "misses": self.misses,
                "writes": self.writes,
                "invalidations": self.invalidations,
                "resident": len(self._mem)}
