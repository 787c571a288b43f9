"""Continuously-admitting async serving loop over the counting engines (a
copy of the JAX package's ``service/async_loop.py`` over the port's).

:class:`AsyncCountingService` replaces the round barrier of
:class:`~repro_torch.service.scheduler.CountingService` with a dispatcher
thread that runs for the life of the service: requests are admitted at
any time from any thread, joined into in-flight dispatch groups between
iterations, and scheduled by QoS class. It *reuses* the round
scheduler's group machinery (``_Group`` sample streams, Welford
consumption, retire-at-target) — every sample is a deterministic
function of ``(seed, iteration id)``, so an async request's estimate is
bitwise-identical to what the synchronous round scheduler would have
produced for the same request.

What the async loop adds on top of the base scheduler:

* **Continuous admission** — :meth:`submit` is thread-safe and never
  blocks on device work; cold engine builds happen on the dispatcher
  thread *outside* the admission lock, so a compile never stalls intake.
* **QoS dispatch order** — at every dispatch boundary the policy
  (:class:`~repro_torch.service.qos.FairScheduler`) picks ONE group:
  deadline-class work earliest-deadline-first ahead of everything,
  interactive before batch, weighted fair queuing across tenants within
  a class. Contrast the round barrier, which extends *all* groups every
  round and makes interactive tail latency a function of total load.
* **Backpressure** — a bounded admission queue; when it is full the
  request is rejected with status ``SHED`` (reason ``queue_full``)
  instead of joining an unbounded backlog. Requests whose modeled memory
  (the executor's :func:`~repro_torch.core.executor.pick_execution`) cannot
  fit the service budget even with colorset chunking are shed at
  admission (``memory_budget``) — before any engine build is wasted.
* **Warm engine pools** — popular ``(graph, template)`` pairs are
  pre-materialized through the shared :class:`EngineCache` whenever the
  dispatcher is idle (plus an explicit :meth:`prewarm` API), so a cold
  engine build (the operand's host build and its copy to the card, and
  the kernel library's first load) lands on idle time, not on an
  interactive request.

Metrics: ``service_queue_depth`` / ``service_queue_admitted_total``,
``service_shed_total{reason}``, ``service_inflight_requests``, per-class
``service_request_total_seconds{qos}`` / ``service_request_queue_seconds
{qos}`` histograms, ``service_async_requests_total{status,qos}``,
``service_deadline_total{outcome}``, ``service_warm_builds_total``.

Typical use::

    svc = AsyncCountingService(max_queue_depth=512)
    svc.add_graph("g", g)
    with svc:                                   # starts the dispatcher
        rid = svc.submit(CountRequest("g", "u5", rel_stderr=0.05),
                         qos=QoS(klass="interactive", tenant="alice"))
        res = svc.result(rid, timeout=30.0)
"""

from __future__ import annotations

import threading
import time

from repro_torch.core import executor as pexec
from repro_torch.obs import metrics as _metrics
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.retry import RetryPolicy
from repro_torch.service.qos import (SHED_CLOSED, SHED_MEMORY,
                                     AdmissionQueue, FairScheduler,
                                     GroupView, QoS, QoSClass)
from repro_torch.service.requests import (CountRequest, RequestResult,
                                          RequestStatus)
from repro_torch.service.scheduler import (CountingService, _Group,
                                           _ReqState)

__all__ = ["AsyncCountingService", "DispatcherDead", "TERMINAL_STATUSES"]

TERMINAL_STATUSES = frozenset((
    RequestStatus.DONE, RequestStatus.FAILED,
    RequestStatus.CANCELLED, RequestStatus.SHED))


class DispatcherDead(RuntimeError):
    """The dispatcher thread crashed past its restart budget; live
    requests are failed with this so nothing waits forever."""

    def __init__(self, crashes: int, cause: BaseException):
        self.crashes = crashes
        self.cause = cause
        super().__init__(
            f"dispatcher dead after {crashes} crashes "
            f"(last: {type(cause).__name__}: {cause})")


class AsyncCountingService(CountingService):
    """Continuously-admitting, QoS-aware counting service (module
    docstring has the full narrative).

    Parameters beyond :class:`CountingService`:

    max_queue_depth:
        Bound on requests admitted but not yet attached; a full queue
        sheds (status ``SHED``, reason ``queue_full``).
    shed_on_memory:
        Shed requests whose modeled peak memory cannot fit
        ``memory_budget_bytes`` even chunked (reason ``memory_budget``).
    warm_pool:
        Pre-materialize popular (graph, template) engines on idle
        dispatcher time (and honor :meth:`prewarm` hints).
    idle_wait_s:
        Dispatcher sleep granularity when there is nothing to do.
    max_dispatcher_restarts:
        Failure containment for the dispatcher thread itself: an
        unhandled exception escaping the loop restarts it (after
        re-queueing any drained-but-unattached requests) up to this many
        times; past the budget, every live request is failed with a
        structured ``DispatcherDead`` error and the service stops
        admitting — admitted requests always reach a terminal status,
        never orphaned limbo.
    """

    def __init__(self, *, max_queue_depth: int = 1024,
                 shed_on_memory: bool = True, warm_pool: bool = True,
                 idle_wait_s: float = 0.05,
                 max_dispatcher_restarts: int = 3, **kw):
        # async dispatches default to a wall-clock watchdog: a hung device
        # call must not freeze the only dispatcher thread forever
        if kw.get("retry_policy") is None:
            kw["retry_policy"] = RetryPolicy(timeout_s=120.0)
        super().__init__(**kw)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._queue = AdmissionQueue(max_queue_depth)
        self._policy = FairScheduler()
        self._qos: dict[str, QoS] = {}
        self._deadline_abs: dict[str, float] = {}
        self._retire_order: list[str] = []
        self.shed_on_memory = shed_on_memory
        self.warm_pool = warm_pool
        self.idle_wait_s = float(idle_wait_s)
        self._fits_memo: dict[tuple, bool] = {}
        self._warm_hints: list[tuple] = []
        self._popularity: dict[tuple, tuple[int, tuple]] = {}
        self._thread: threading.Thread | None = None
        self._running = False
        self._closed = False
        self.max_dispatcher_restarts = int(max_dispatcher_restarts)
        self._dispatcher_crashes = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "AsyncCountingService":
        """Start the supervised dispatcher thread (idempotent)."""
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._running = True
            self._closed = False
            self._dispatcher_crashes = 0
            self._thread = threading.Thread(
                target=self._supervise, name="pgbsc-async-dispatcher",
                daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float | None = 30.0) -> None:
        """Stop admitting, shed anything still queued (reason ``closed``),
        and join the dispatcher. In-flight device work completes and
        flushes its ledger checkpoint first."""
        with self._cv:
            self._closed = True
            self._running = False
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def __enter__(self) -> "AsyncCountingService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, max_rounds: int = 100_000):
        """The synchronous round driver stays available for offline batch
        jobs — but not while the async dispatcher owns the groups."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "run() is the synchronous round driver; this service's "
                "async dispatcher is running — use wait()/result()")
        return super().run(max_rounds)

    # ------------------------------------------------------------ admission
    def submit(self, request: CountRequest, qos: QoS | None = None) -> str:
        """Admit a request from any thread; returns its id immediately.

        Outcomes: served from the estimate cache (``DONE``), queued for
        the dispatcher (``PENDING``), or rejected (``SHED`` with
        :meth:`shed_reason` — queue full, modeled memory over budget, or
        service closed). Never blocks on device work.
        """
        q = qos or QoS()
        with self._cv:
            rid = super().submit(request)     # validate + cache fast path
            st = self._requests[rid]
            self._qos[rid] = q
            key = (request.graph, request.spec.canonical_hash,
                   request.engine, request.plan)
            n_seen = self._popularity.get(key, (0, None))[0] + 1
            self._popularity[key] = (
                n_seen, (request.graph, request.spec, request.engine,
                         request.plan))
            if st.status is RequestStatus.DONE:      # estimate-cache hit
                _metrics.counter("service_async_requests_total",
                                 status="cached", qos=q.klass.value).inc()
                self._cv.notify_all()
                return rid
            if self._closed:
                self._shed(rid, st, SHED_CLOSED, q)
                return rid
            if self.shed_on_memory and not self._modeled_fits(request):
                self._shed(rid, st, SHED_MEMORY, q)
                return rid
            reason = self._queue.offer(rid)
            if reason is not None:
                self._shed(rid, st, reason, q)
                return rid
            if q.deadline_s is not None:
                self._deadline_abs[rid] = time.monotonic() + q.deadline_s
            self._cv.notify_all()
            return rid

    def _shed(self, rid: str, st: _ReqState, reason: str, q: QoS) -> None:
        st.status = RequestStatus.SHED
        st.error = reason
        _metrics.counter("service_shed_total", reason=reason).inc()
        _metrics.counter("service_async_requests_total",
                         status="shed", qos=q.klass.value).inc()
        self._cv.notify_all()

    def shed_reason(self, rid: str) -> str | None:
        st = self._requests[rid]
        return st.error if st.status is RequestStatus.SHED else None

    def qos_of(self, rid: str) -> QoS | None:
        return self._qos.get(rid)

    def _modeled_fits(self, request: CountRequest) -> bool:
        """Admission-time memory check: can this template's plan walk fit
        the service budget at all (batch 1, colorset chunking allowed)?
        Uses the executor's analytic model only — no engine build, no
        device work. Unknown plans pass (they fail at attach with a
        better error)."""
        if self.memory_budget_bytes is None:
            return True
        g = self.graphs[request.graph]
        spec = request.spec
        memo_key = (g.fingerprint, spec.canonical_hash, request.engine,
                    request.plan, self.memory_budget_bytes)
        hit = self._fits_memo.get(memo_key)
        if hit is not None:
            return hit
        t = spec.tree
        plan = {"plain": t.plan, "dedup": t.plan_dedup,
                "optimized": t.plan_optimized}.get(request.plan)
        if plan is None:
            return True
        choice = pexec.pick_execution(
            plan, t.k, g.n,
            memory_budget_bytes=self.memory_budget_bytes,
            passive_cache=(request.engine != "fascia"),
            allow_chunking=(request.engine == "pgbsc"))
        self._fits_memo[memo_key] = choice.fits
        return choice.fits

    # ------------------------------------------------------------- results
    def cancel(self, rid: str) -> None:
        with self._cv:
            super().cancel(rid)
            self._cv.notify_all()

    def wait(self, rids, timeout: float | None = None) -> bool:
        """Block until every listed request is terminal (DONE / FAILED /
        CANCELLED / SHED); returns False on timeout."""
        if isinstance(rids, str):
            rids = [rids]
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if all(self._requests[r].status in TERMINAL_STATUSES
                       for r in rids):
                    return True
                remaining = self.idle_wait_s if deadline is None else \
                    deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 1.0))

    def result(self, rid: str,
               timeout: float | None = None) -> RequestResult:
        """The request's result; with ``timeout`` set, blocks until the
        request is terminal (or the timeout lapses) first."""
        if timeout is not None:
            self.wait([rid], timeout)
        return super().result(rid)

    def drain(self, timeout: float | None = None) -> bool:
        """Block until no request is PENDING or RUNNING and the admission
        queue is empty; returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                busy = len(self._queue) or any(
                    st.status in (RequestStatus.PENDING,
                                  RequestStatus.RUNNING)
                    for st in self._requests.values())
                if not busy:
                    return True
                remaining = self.idle_wait_s if deadline is None else \
                    deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(min(remaining, 1.0))

    def retired_order(self) -> list[str]:
        """Request ids in retirement order (QoS-invariant tests)."""
        with self._cv:
            return list(self._retire_order)

    def _retire(self, rid: str, st: _ReqState) -> None:
        super()._retire(rid, st)
        self._retire_order.append(rid)
        q = self._qos.get(rid)
        if q is None:
            return
        b = st.result.breakdown or {}
        _metrics.histogram("service_request_total_seconds",
                           qos=q.klass.value).observe(b.get("total_s", 0.0))
        _metrics.histogram("service_request_queue_seconds",
                           qos=q.klass.value).observe(b.get("queue_s", 0.0))
        _metrics.counter("service_async_requests_total",
                         status="done", qos=q.klass.value).inc()
        if q.klass is QoSClass.DEADLINE:
            met = time.monotonic() <= self._deadline_abs.get(
                rid, float("inf"))
            _metrics.counter("service_deadline_total",
                             outcome="met" if met else "missed").inc()

    # ------------------------------------------------------------ warm pool
    def prewarm(self, graph: str, template, engine: str = "pgbsc",
                plan: str = "optimized") -> None:
        """Hint the warm pool: materialize this (graph, template) engine on
        dispatcher idle time, ahead of any request needing it."""
        with self._cv:
            self._warm_hints.append((graph, template, engine, plan))
            self._cv.notify_all()

    def _next_warm_task(self) -> tuple | None:
        """Called under the lock: an explicit prewarm hint first, then the
        most popular pair whose engine is not cache-resident."""
        if not self.warm_pool:
            return None
        while self._warm_hints:
            task = self._warm_hints.pop(0)
            if not self._engine_resident(task):
                return task
        ranked = sorted(self._popularity.values(),
                        key=lambda cv: -cv[0])
        for _, task in ranked:
            if not self._engine_resident(task):
                return task
        return None

    def _engine_resident(self, task: tuple) -> bool:
        graph, template, engine, plan = task
        g = self.graphs.get(graph)
        if g is None:
            return True                       # unknown graph: nothing to do
        try:
            return self.engine_cache.has(g, template, engine, plan,
                                         **self.engine_kw)
        except Exception:
            return True                       # unbuildable key: skip warming
        # (a template that cannot even key will fail loudly at attach)

    def _do_warm(self, task: tuple) -> None:
        """Build one warm engine (dispatcher thread, outside the lock)."""
        graph, template, engine, plan = task
        g = self.graphs.get(graph)
        if g is None:
            return
        try:
            self.engine_cache.get(g, template, engine, plan,
                                  **self.engine_kw)
            _metrics.counter("service_warm_builds_total").inc()
        except Exception:
            _metrics.counter("service_warm_failures_total").inc()

    # ----------------------------------------------------------- dispatcher
    def _attach_async(self, rid: str) -> None:
        """Attach one admitted request: join an existing group under the
        lock, or build the group (engine + ledger resume) outside it."""
        with self._cv:
            st = self._requests[rid]
            if st.status is not RequestStatus.PENDING:
                return                        # cancelled while queued
            t_start = time.perf_counter()
            st.queue_s = max(0.0, t_start - st.t_submit_pc)
            _metrics.histogram("service_request_queue_seconds").observe(
                st.queue_s)
            g = self.graphs[st.request.graph]
            key = st.request.group_key(g.fingerprint)
            grp = self._groups.get(key)
            if grp is not None:
                st.shared_group = True
                self._join(rid, st, grp)
                return
        try:                                  # slow path: outside the lock
            built, build_s = self._build_group(st)
        except Exception as exc:
            with self._cv:
                st.status = RequestStatus.FAILED
                st.error = f"{type(exc).__name__}: {exc}"
                _metrics.counter("service_requests_total",
                                 status="failed").inc()
                self._cv.notify_all()
            return
        with self._cv:
            grp = self._groups.get(key)
            if grp is None:
                grp = built
                self._groups[key] = grp
                st.build_s = build_s
            else:
                st.shared_group = True        # lost a (theoretical) race
            if st.status is RequestStatus.PENDING:
                self._join(rid, st, grp)

    def _join(self, rid: str, st: _ReqState, grp: _Group) -> None:
        grp.members.append(rid)
        st.group_key = grp.key
        st.status = RequestStatus.RUNNING
        st.t_attach_pc = time.perf_counter()
        self._cv.notify_all()

    def _group_views(self) -> list[GroupView]:
        """Dispatchable groups as policy views (called under the lock);
        creation order is preserved so policy ties resolve FIFO."""
        views: list[GroupView] = []
        for key, grp in self._groups.items():
            live = [r for r in grp.members
                    if self._requests[r].status is RequestStatus.RUNNING]
            if not live:
                continue
            rank = min(self._qos.get(r, _DEFAULT_QOS).klass.rank
                       for r in live)
            deadline = min((self._deadline_abs[r] for r in live
                            if r in self._deadline_abs),
                           default=float("inf"))
            tenants: dict[str, float] = {}
            for r in live:
                q = self._qos.get(r, _DEFAULT_QOS)
                tenants[q.tenant] = max(tenants.get(q.tenant, 0.0),
                                        q.weight)
            views.append(GroupView(key=key, rank=rank, deadline=deadline,
                                   tenants=tuple(tenants.items())))
        return views

    def _supervise(self) -> None:
        """Dispatcher thread body: run :meth:`_loop`, and when an
        exception escapes it (a bug, a poisoned attach, an injected
        ``dispatch.loop`` fault), contain it — restart the loop with
        drained-but-unattached requests re-queued, up to
        ``max_dispatcher_restarts``; past the budget fail every live
        request with :class:`DispatcherDead` and stop admitting. Either
        way, every admitted request reaches a terminal status."""
        while True:
            try:
                self._loop()
                return                              # clean shutdown
            except BaseException as exc:
                _metrics.counter("dispatcher_crashes_total").inc()
                with self._cv:
                    self._dispatcher_crashes += 1
                    crashed_out = (self._dispatcher_crashes
                                   > self.max_dispatcher_restarts)
                    if crashed_out or not self._running:
                        self._running = False
                        self._closed = True        # future submits shed
                        self._fail_live(exc)
                        self._cv.notify_all()
                        return
                    self._requeue_unattached()
                _metrics.counter("dispatcher_restarts_total").inc()

    def _requeue_unattached(self) -> None:
        """Re-offer PENDING requests the crashed loop drained but never
        attached (called under the lock). A full queue sheds them —
        terminal either way, never silently dropped."""
        queued = set(self._queue.contents())
        for rid, st in self._requests.items():
            if st.status is RequestStatus.PENDING and \
                    st.group_key is None and rid not in queued:
                reason = self._queue.offer(rid)
                if reason is not None:
                    self._shed(rid, st, reason,
                               self._qos.get(rid, _DEFAULT_QOS))

    def _fail_live(self, cause: BaseException) -> None:
        """Fail every PENDING/RUNNING request with a structured
        DispatcherDead error (called under the lock)."""
        exc = DispatcherDead(self._dispatcher_crashes, cause)
        for st in self._requests.values():
            if st.status in (RequestStatus.PENDING, RequestStatus.RUNNING):
                self._fail_member(st, exc)

    def _loop(self) -> None:
        while True:
            _faults.inject("dispatch.loop", context="async")
            with self._cv:
                if not self._running:
                    for rid in self._queue.drain():
                        st = self._requests[rid]
                        if st.status is RequestStatus.PENDING:
                            self._shed(rid, st, SHED_CLOSED,
                                       self._qos.get(rid, _DEFAULT_QOS))
                    self._cv.notify_all()
                    return
                pending = self._queue.drain()
            for rid in pending:               # builds happen outside the
                self._attach_async(rid)       # lock; submit stays live
            picked = None
            with self._cv:
                self._consume_and_retire()
                self._publish_inflight()
                views = self._group_views()
                if views:
                    gv = self._policy.pick(views)
                    grp = self._groups[gv.key]
                    ids = self._plan_dispatch(grp)
                    if ids is not None:
                        picked = (gv, grp, ids)
            if picked is not None:
                gv, grp, ids = picked
                # device work runs without the lock: admission, cancel,
                # and waiters stay responsive during a dispatch
                self._dispatch_ids(grp, ids)
                with self._cv:
                    self._policy.charge(gv.tenants, len(ids))
                    self._consume_and_retire()
                    self._release_idle_engines()
                    self._publish_inflight()
                    self._cv.notify_all()
                continue
            warm = None
            with self._cv:
                if not len(self._queue):
                    warm = self._next_warm_task()
            if warm is not None:
                self._do_warm(warm)
                continue
            with self._cv:
                if self._running and not len(self._queue):
                    self._cv.wait(self.idle_wait_s)

    def _publish_inflight(self) -> None:
        n = sum(st.status in (RequestStatus.PENDING, RequestStatus.RUNNING)
                for st in self._requests.values())
        _metrics.gauge("service_inflight_requests").set(n)

    # ------------------------------------------------------------- insight
    def stats(self) -> dict:
        s = super().stats()
        s["queue_depth"] = len(self._queue)
        s["shed"] = sum(st.status is RequestStatus.SHED
                        for st in self._requests.values())
        s["tenant_virtual_time"] = self._policy.virtual_times()
        s["dispatcher_crashes"] = self._dispatcher_crashes
        return s

    def resilience_state(self) -> dict:
        s = super().resilience_state()
        t = self._thread
        s["dispatcher"] = {
            "alive": bool(t is not None and t.is_alive()),
            "crashes": self._dispatcher_crashes,
            "max_restarts": self.max_dispatcher_restarts,
        }
        return s


_DEFAULT_QOS = QoS()
