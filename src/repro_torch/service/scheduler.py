"""Round-based adaptive-precision scheduler for the counting service (a
copy of the JAX package's ``service/scheduler.py`` over the port's
engines, on the card unless the service is given ``device="cpu"``).

The scheduler turns a set of live :class:`CountRequest`\\ s into the minimum
number of device dispatches:

* requests sharing a ``(graph fingerprint, template canonical hash,
  engine, plan, seed)`` key are attached to one **dispatch group** with a
  single deterministic sample stream (iteration ids 0, 1, 2, ... colored by
  ``fold_in(seed, id)``), so N concurrent tenants asking the same question
  cost the same device work as one — template identity is the *canonical
  hash*, so a registry name and a relabeled edge list of the same tree are
  the same question;
* each scheduling round extends every active group by up to ``round_size``
  iterations through ONE ``count_iterations_batch`` dispatch (via the
  fault-tolerant :class:`EstimatorRunner` ledger, so a killed service
  resumes where it stopped);
* every member request folds the new samples into a Welford running
  mean/stderr and **retires the moment its relative standard error hits its
  target**, instead of burning a fixed iteration budget.

Because samples are deterministic functions of (seed, iteration id), a
request that joins a group late — or a service that restarts on an existing
ledger — consumes the exact samples a solo run would have produced:
cross-request batching and resume are estimate-invariant.
"""

from __future__ import annotations

import os
import random
import tempfile
import time
import dataclasses

from repro_torch.core.colorsets import colorful_probability
from repro_torch.core.runner import EstimatorRunner, engine_counter
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.degradation import (BreakerBoard, CircuitOpen,
                                                DegradationState)
from repro_torch.resilience.retry import (DispatchTimeout, RetryPolicy,
                                          run_with_timeout)
from repro_torch.service.cache import EngineCache, EstimateCache
from repro_torch.service.requests import (CountRequest, RequestResult,
                                          RequestStatus, RunningStat)

__all__ = ["CountingService"]


@dataclasses.dataclass
class _Group:
    """One dispatch group: a shared deterministic sample stream."""

    key: tuple
    graph_name: str
    runner: EstimatorRunner
    engine: object
    scale: float                 # 1 / (automorphisms * colorful_probability)
    history: list[float]         # history[i] = scaled sample of iteration i
    cursor: int                  # next fresh iteration id (== len(history))
    members: list[str]
    # rebuild identity (degradation-ladder step-down/re-promotion swaps the
    # engine underneath the runner without losing the sample stream)
    spec: object = None
    engine_name: str = "pgbsc"
    plan_name: str = "optimized"
    seed: int = 0
    label: str = ""              # fault-point context / breaker label


@dataclasses.dataclass
class _ReqState:
    request: CountRequest
    status: RequestStatus
    stat: RunningStat
    consumed: int = 0
    group_key: tuple | None = None
    shared_group: bool = False
    from_cache: bool = False
    result: RequestResult | None = None
    error: str | None = None
    error_class: str | None = None   # structured error (exception class)
    t_submit: float = 0.0
    # latency attribution (perf_counter clock): submit -> attach start is
    # queue time, engine build inside attach is compile time, attach end ->
    # retire is execute time
    t_submit_pc: float = 0.0
    t_attach_pc: float = 0.0
    queue_s: float = 0.0
    build_s: float = 0.0

    @property
    def cap(self) -> int:
        return self.request.max_iters if self.request.max_iters is not None \
            else self._default_cap

    _default_cap: int = 0


class CountingService:
    """Multi-tenant subgraph-counting service (see module docstring).

    Parameters
    ----------
    ledger_root:
        Directory for per-group iteration ledgers (fault tolerance /
        resume). Defaults to a fresh temporary directory.
    engine_cache / estimate_cache:
        Shared caches; pass explicitly to share engines across services or
        persist estimates across processes (``estimate_cache`` may be a
        path string, an :class:`EstimateCache`, or None for in-memory).
    round_size:
        Fresh iterations dispatched per group per scheduling round; also
        the adaptive-stopping granularity.
    default_max_iters:
        Iteration cap for requests that specify only ``rel_stderr`` — the
        hard bound that keeps zero-count or high-variance queries finite.
    batch_size:
        Engine chunking knob forwarded to ``engine_counter`` (None = the
        engine's budget-derived default).
    memory_budget_bytes:
        Per-engine device-memory budget forwarded to every engine build
        (part of the engine-cache key): the executor's memory model turns
        it into the dispatch batch size — and into colorset-chunked
        execution for templates whose single-coloring footprint already
        exceeds it. None = the executor default budget.
    engine_kw:
        Extra build options forwarded to every engine construction (e.g.
        ``spmm_method``); part of the engine-cache key.
    device:
        Where every engine of the service runs: ``None`` means CUDA, and
        raises ``RuntimeError`` when there is no card; ``"cpu"`` runs the
        kernels' plain versions. Part of the engine-cache key.
    retry_policy:
        Dispatch-path containment (:class:`~repro_torch.resilience.retry.
        RetryPolicy`): per-dispatch retry budget, jittered exponential
        backoff, and (when ``timeout_s`` is set) a wall-clock watchdog
        that abandons hung dispatches. None = the default policy (4
        attempts, no watchdog). An out-of-memory error is a failed
        attempt like any other: it steps the ladder.
    degrade_after / degrade_cooldown_s:
        Degradation-ladder shape: consecutive failures per step-down, and
        the failure-free interval before a one-rung re-promotion.
    breaker_threshold / breaker_cooldown_s:
        Circuit breaker per dispatch group: consecutive *exhausted*
        dispatches before the group's circuit opens (poison quarantine —
        requests fail fast instead of retrying forever), and the cool-down
        before a half-open trial dispatch.
    """

    def __init__(self, *, ledger_root: str | None = None,
                 engine_cache: EngineCache | None = None,
                 estimate_cache: EstimateCache | str | None = None,
                 round_size: int = 8, default_max_iters: int = 256,
                 checkpoint_every: int | None = None,
                 batch_size: int | None = None,
                 memory_budget_bytes: int | None = None,
                 engine_kw: dict | None = None, device=None,
                 retry_policy: RetryPolicy | None = None,
                 degrade_after: int = 2, degrade_cooldown_s: float = 60.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0):
        self.ledger_root = ledger_root or tempfile.mkdtemp(
            prefix="pgbsc_service_")
        # explicit None checks: both caches define __len__, so a fresh
        # (empty) shared cache passed by the caller is falsy
        self.engine_cache = EngineCache() if engine_cache is None \
            else engine_cache
        if isinstance(estimate_cache, str):
            estimate_cache = EstimateCache(estimate_cache)
        self.estimate_cache = EstimateCache() if estimate_cache is None \
            else estimate_cache
        self.round_size = int(round_size)
        self.default_max_iters = int(default_max_iters)
        self.checkpoint_every = checkpoint_every or self.round_size
        self.batch_size = batch_size
        self.engine_kw = dict(engine_kw or {})
        self.device = resolve_device(device)
        self.engine_kw["device"] = self.device
        if memory_budget_bytes is not None:
            self.engine_kw["memory_budget_bytes"] = int(memory_budget_bytes)
        self.memory_budget_bytes = memory_budget_bytes
        self.retry_policy = retry_policy or RetryPolicy()
        self.degrade_after = int(degrade_after)
        self.degrade_cooldown_s = float(degrade_cooldown_s)
        self._breakers = BreakerBoard(threshold=breaker_threshold,
                                      cooldown_s=breaker_cooldown_s)
        self._ladders: dict[tuple, DegradationState] = {}
        # jittered-backoff stream (seeded: chaos runs are reproducible)
        self._retry_rng = random.Random(0xC0FFEE)
        self.graphs: dict[str, Graph] = {}
        self._requests: dict[str, _ReqState] = {}
        self._groups: dict[tuple, _Group] = {}
        self._seq = 0

    # ------------------------------------------------------------- tenants
    def add_graph(self, name: str, g: Graph) -> str:
        """Register a graph under ``name``; returns its content fingerprint."""
        self.graphs[name] = g
        return g.fingerprint

    def submit(self, request: CountRequest) -> str:
        """Queue a request; returns its id. Served instantly (status DONE,
        ``from_cache``) when the persistent estimate cache already holds an
        answer meeting the request's precision contract."""
        request.validate()               # fails fast on unknown/invalid
        #  templates too (names are sugar; arbitrary edge lists first-class)
        if request.graph not in self.graphs:
            raise KeyError(f"unknown graph {request.graph!r}; "
                           f"registered: {sorted(self.graphs)}")
        self._seq += 1
        rid = f"r{self._seq:04d}"
        st = _ReqState(request=request, status=RequestStatus.PENDING,
                       stat=RunningStat(), t_submit=time.time(),
                       t_submit_pc=time.perf_counter())
        st._default_cap = self.default_max_iters
        fp = self.graphs[request.graph].fingerprint
        ck = EstimateCache.key(fp, request.spec, request.engine,
                               request.plan, request.seed)
        ent = self.estimate_cache.satisfies(ck, request.rel_stderr,
                                            request.max_iters,
                                            request.min_iters)
        if ent is not None:
            se = float(ent["stderr"])
            st.status = RequestStatus.DONE
            st.from_cache = True
            st.result = RequestResult(
                estimate=float(ent["estimate"]), stderr=se,
                rel_stderr=float(ent["rel_stderr"]),
                ci95=(float(ent["estimate"]) - 1.96 * se,
                      float(ent["estimate"]) + 1.96 * se),
                iterations=int(ent["iterations"]), target_met=True,
                from_cache=True, seconds=0.0)
            _metrics.counter("service_requests_total",
                             status="cached").inc()
        self._requests[rid] = st
        return rid

    def status(self, rid: str) -> RequestStatus:
        return self._requests[rid].status

    def result(self, rid: str) -> RequestResult:
        st = self._requests[rid]
        if st.result is None:
            raise RuntimeError(f"request {rid} is {st.status.value}"
                               + (f": {st.error}" if st.error else ""))
        return st.result

    def cancel(self, rid: str) -> None:
        """Withdraw a request. Cancelling the last live member of a group
        drains the group *before* the next round, not after: every round
        re-checks liveness immediately before dispatching
        (:meth:`_plan_dispatch`), so a drained group never costs another
        device dispatch. A dispatch already in flight when the cancel
        lands still completes and flushes its runner-ledger checkpoint —
        those samples are real work and serve any future joiner."""
        st = self._requests[rid]
        if st.status in (RequestStatus.PENDING, RequestStatus.RUNNING):
            st.status = RequestStatus.CANCELLED
            _metrics.counter("service_requests_total",
                             status="cancelled").inc()

    # ----------------------------------------------------------- resilience
    def _ladder_for(self, key: tuple) -> DegradationState:
        """The degradation ladder for one engine-build identity (the group
        key minus the seed: graph, template, engine, plan)."""
        lk = key[:4]
        lad = self._ladders.get(lk)
        if lad is None:
            lad = DegradationState(engine=str(key[2]),
                                   template=str(key[1])[:8],
                                   step_after=self.degrade_after,
                                   cooldown_s=self.degrade_cooldown_s)
            self._ladders[lk] = lad
        return lad

    @staticmethod
    def _group_label(request: CountRequest, fingerprint: str) -> str:
        return (f"{fingerprint[:8]}:{request.spec.canonical_hash[:8]}:"
                f"{request.engine}:{request.plan}:s{request.seed}")

    def _fail_member(self, st: _ReqState, exc: BaseException) -> None:
        st.status = RequestStatus.FAILED
        st.error = f"{type(exc).__name__}: {exc}"
        st.error_class = type(exc).__name__
        _metrics.counter("service_requests_total", status="failed").inc()

    def _rebuild_group_engine(self, grp: _Group,
                              ladder: DegradationState) -> None:
        """Swap the group's engine for one built at the ladder's current
        level. The runner (and its ledger) survive — the sample stream is
        a pure function of ``(seed, iteration id)``, so an engine swap is
        estimate-invariant."""
        g = self.graphs[grp.graph_name]
        eng = self.engine_cache.get(g, grp.spec, grp.engine_name,
                                    grp.plan_name,
                                    **ladder.apply(self.engine_kw))
        grp.engine = eng
        grp.runner.counter = engine_counter(
            eng, seed=grp.seed, batch_size=self.batch_size, label=grp.label)
        _metrics.counter("engine_rebuilds_total",
                         level=ladder.level_name).inc()

    def resilience_state(self) -> dict:
        """Degradation-ladder and circuit-breaker state (``/healthz``)."""
        ladders = {}
        for (fp, th, eng, plan), lad in self._ladders.items():
            if lad.level > 0:
                ladders[f"{str(th)[:8]}:{eng}:{plan}"] = lad.snapshot()
        return {"degraded_ladders": ladders,
                "ladder_total": len(self._ladders),
                "breakers": self._breakers.snapshot()}

    # ----------------------------------------------------------- scheduling
    def _build_group(self, st: _ReqState) -> tuple[_Group, float]:
        """Construct the dispatch group for ``st``'s request: engine build
        (or cache hit) plus ledger resume. This is the slow half of attach
        — the async front end runs it outside its admission lock so a cold
        compile never blocks new submissions. Returns ``(group,
        build_seconds)``; the caller registers the group.

        Builds run at the group's degradation-ladder level; a failed build
        that steps the ladder down (e.g. an OOM at the fused/bf16 level)
        retries at the degraded level before giving up."""
        g = self.graphs[st.request.graph]
        spec = st.request.spec
        t = spec.tree
        key = st.request.group_key(g.fingerprint)
        label = self._group_label(st.request, g.fingerprint)
        ladder = self._ladder_for(key)
        t_build = time.perf_counter()
        while True:
            try:
                eng = self.engine_cache.get(
                    g, spec, st.request.engine,
                    st.request.plan, **ladder.apply(self.engine_kw))
                break
            except Exception:
                if not ladder.on_failure(reason="build_error"):
                    raise
                # stepped down: retry the build with the degraded options
        build_s = time.perf_counter() - t_build
        scale = 1.0 / (t.automorphisms * colorful_probability(t.k))
        # canonical hash, not name: two spellings of one tree resume
        # the same ledger
        ledger_dir = os.path.join(
            self.ledger_root,
            f"{g.fingerprint[:12]}_{spec.canonical_hash}_"
            f"{st.request.engine}_{st.request.plan}_s{st.request.seed}")
        runner = EstimatorRunner(
            engine_counter(eng, seed=st.request.seed,
                           batch_size=self.batch_size, label=label),
            k=t.k, automorphisms=t.automorphisms, n_iterations=None,
            ledger_dir=ledger_dir,
            checkpoint_every=self.checkpoint_every,
            seed=st.request.seed)
        # resume: ledgered contiguous prefix becomes instant history
        led = runner.completed_iterations()
        history: list[float] = []
        while len(history) in led:
            history.append(led[len(history)] * scale)
        return _Group(key=key, graph_name=st.request.graph, runner=runner,
                      engine=eng, scale=scale, history=history,
                      cursor=len(history), members=[], spec=spec,
                      engine_name=st.request.engine,
                      plan_name=st.request.plan, seed=st.request.seed,
                      label=label), build_s

    def _attach(self, rid: str, st: _ReqState) -> None:
        t_start = time.perf_counter()
        st.queue_s = max(0.0, t_start - st.t_submit_pc)
        _metrics.histogram("service_request_queue_seconds").observe(
            st.queue_s)
        g = self.graphs[st.request.graph]
        key = st.request.group_key(g.fingerprint)
        grp = self._groups.get(key)
        if grp is None:
            # compile time is attributed to the group creator; joiners
            # inherit a warm engine and report build_s = 0
            grp, st.build_s = self._build_group(st)
            self._groups[key] = grp
        else:
            st.shared_group = True
        grp.members.append(rid)
        st.group_key = key
        st.status = RequestStatus.RUNNING
        st.t_attach_pc = time.perf_counter()

    def _satisfied(self, st: _ReqState) -> bool:
        n = st.stat.n
        if n >= st.cap:
            return True
        tgt = st.request.rel_stderr
        return (tgt is not None and n >= min(st.request.min_iters, st.cap)
                and st.stat.rel_stderr <= tgt)

    def _retire(self, rid: str, st: _ReqState) -> None:
        stat = st.stat
        tgt = st.request.rel_stderr
        st.status = RequestStatus.DONE
        now = time.perf_counter()
        total_s = max(0.0, now - st.t_submit_pc)
        execute_s = max(0.0, now - st.t_attach_pc)
        breakdown = {"queue_s": st.queue_s, "compile_s": st.build_s,
                     "execute_s": execute_s, "total_s": total_s}
        _metrics.histogram("service_request_compile_seconds").observe(
            st.build_s)
        _metrics.histogram("service_request_execute_seconds").observe(
            execute_s)
        _metrics.histogram("service_request_total_seconds").observe(total_s)
        _metrics.counter("service_requests_total", status="done").inc()
        st.result = RequestResult(
            estimate=stat.mean, stderr=stat.stderr,
            rel_stderr=stat.rel_stderr, ci95=stat.ci95, iterations=stat.n,
            target_met=(tgt is None or stat.rel_stderr <= tgt),
            from_cache=False, shared_group=st.shared_group,
            seconds=time.time() - st.t_submit, breakdown=breakdown)
        g = self.graphs[st.request.graph]
        ck = EstimateCache.key(g.fingerprint, st.request.spec,
                               st.request.engine, st.request.plan,
                               st.request.seed)
        prev = self.estimate_cache.get(ck)
        if prev is None or prev["iterations"] < stat.n:
            self.estimate_cache.put(ck, {
                "estimate": stat.mean, "stderr": stat.stderr,
                "rel_stderr": stat.rel_stderr, "iterations": stat.n})

    def _consume_and_retire(self) -> None:
        for rid, st in self._requests.items():
            if st.status is not RequestStatus.RUNNING:
                continue
            grp = self._groups[st.group_key]
            hi = min(len(grp.history), st.cap)
            while st.consumed < hi:
                st.stat.update(grp.history[st.consumed])
                st.consumed += 1
                if self._satisfied(st):
                    break
            if self._satisfied(st):
                self._retire(rid, st)

    def _live_members(self, grp: _Group) -> list[_ReqState]:
        return [self._requests[rid] for rid in grp.members
                if self._requests[rid].status is RequestStatus.RUNNING]

    def _plan_dispatch(self, grp: _Group) -> list[int] | None:
        """Fresh iteration ids for one round of ``grp``, or None when the
        group is drained (every member retired, failed, or cancelled).
        Liveness is evaluated here, immediately before the dispatch it
        plans — so cancelling a group's last live member drains it before
        the next round, never one round late."""
        live = self._live_members(grp)
        if not live:
            return None
        # never dispatch past the last live member's remaining budget
        # (every request has a cap — adaptive ones the service default)
        need = max(m.cap - m.stat.n for m in live)
        n_new = min(self.round_size, max(need, 1))
        return list(range(grp.cursor, grp.cursor + n_new))

    def _dispatch_ids(self, grp: _Group, ids: list[int]) -> bool:
        """Run one planned round and append its scaled samples to the group
        history; returns False when containment gave up (live members are
        marked FAILED with a structured error). The runner checkpoints the
        ledger per batch, so samples computed for a request cancelled
        mid-dispatch are still flushed and serve future joiners.

        Containment order per round:

        1. **circuit breaker** — an open breaker fails the round fast
           (:class:`CircuitOpen`), no device work, no retries;
        2. **re-promotion** — a degraded ladder past its cooldown steps up
           one rung and the engine is rebuilt at the better level;
        3. **watchdog + retry** — each attempt runs under the policy's
           wall-clock timeout (hung dispatches are abandoned, not joined
           forever); failures step the ladder (rebuilding the engine at
           the degraded level) and back off with seeded jitter until the
           attempt budget is exhausted.

        Because samples are pure functions of ``(seed, iteration id)``, a
        retried or degraded dispatch reproduces bitwise-identical
        estimates — containment never perturbs answers.

        On the card the watched attempt ends in the engine's host copy of
        the totals (``count_iterations_batch``), so the watchdog times the
        device work, not its launches. An abandoned attempt's kernels stay
        queued on the stream and its tables stay allocated until they run;
        the retry allocates its own (no engine buffer outlives a dispatch)
        and queues behind them on the same stream.
        """
        ladder = self._ladder_for(grp.key)
        breaker = self._breakers.get(grp.key, label=grp.label)
        if not breaker.allow():
            exc = CircuitOpen(grp.label, breaker.failures)
            for m in self._live_members(grp):
                self._fail_member(m, exc)
            return False
        if ladder.maybe_promote():
            try:
                self._rebuild_group_engine(grp, ladder)
            except Exception:
                ladder.on_failure(reason="rebuild_error")

        policy = self.retry_policy

        def attempt_fn(cancelled):
            _faults.inject("dispatch.hang", context=grp.label)
            if cancelled.is_set():      # watchdog already gave up on us
                return None
            return grp.runner.run_iterations(ids)

        per = None
        last_exc: BaseException | None = None
        for attempt in range(1, policy.max_attempts + 1):
            t_disp = time.perf_counter()
            try:
                with _tracing.span("service.dispatch",
                                   group=grp.graph_name,
                                   engine=grp.key[2], n=len(ids),
                                   tenants=len(self._live_members(grp)),
                                   attempt=attempt):
                    with _tracing.profiled_dispatch():
                        per = run_with_timeout(attempt_fn, policy.timeout_s,
                                               name=grp.label)
                break
            except Exception as exc:
                last_exc = exc
                reason = "timeout" if isinstance(exc, DispatchTimeout) \
                    else "error"
                if ladder.on_failure(reason=f"dispatch_{reason}"):
                    try:
                        self._rebuild_group_engine(grp, ladder)
                    except Exception:
                        pass        # keep the old engine; retry may still work
                if attempt >= policy.max_attempts:
                    break
                _metrics.counter("dispatch_retries_total",
                                 reason=reason).inc()
                time.sleep(policy.delay(attempt, self._retry_rng))
        if per is None:
            breaker.on_failure()
            for m in self._live_members(grp):
                self._fail_member(m, last_exc)
            return False
        breaker.on_success()
        ladder.on_success()
        _metrics.counter("service_dispatches_total").inc()
        _metrics.histogram("service_dispatch_seconds").observe(
            time.perf_counter() - t_disp)
        for i in ids:
            grp.history.append(per[i] * grp.scale)
        grp.cursor += len(ids)
        return True

    def step(self) -> int:
        """One scheduling round; returns the number of live requests left.

        Round shape: attach new requests to groups, let everyone consume
        already-available samples (joins and ledger resumes often finish
        right here, with zero device work), then extend each still-needed
        group by one ``round_size`` batch — a single device dispatch per
        group regardless of how many tenants share it — and consume again.
        """
        _metrics.counter("service_rounds_total").inc()
        with _tracing.span("service.round"):
            for rid, st in list(self._requests.items()):
                if st.status is RequestStatus.PENDING:
                    try:
                        self._attach(rid, st)
                    except Exception as exc:  # unknown engine/plan, build
                        self._fail_member(st, exc)
            self._consume_and_retire()
            for grp in self._groups.values():
                ids = self._plan_dispatch(grp)
                if ids is None:
                    continue
                self._dispatch_ids(grp, ids)
            self._consume_and_retire()
            self._release_idle_engines()
        return sum(st.status in (RequestStatus.PENDING, RequestStatus.RUNNING)
                   for st in self._requests.values())

    def _release_idle_engines(self) -> None:
        """Release device arrays of engines that only idle groups pin.

        Groups are kept forever (their sample history serves late joiners
        instantly), but a retired group must not keep an engine's device
        operand resident after the bounded :class:`EngineCache` evicted it
        — otherwise device memory grows with every distinct group ever
        seen regardless of the cache bound. ``release()`` hands the
        operand's memory back to torch's caching allocator, which reuses
        it for the next engine or table; it does not return it to the card
        (``torch.cuda.empty_cache()`` would).
        Engines still cache-resident stay warm (repeated requests keep the
        no-rebuild/no-recompile guarantee); engines used by any live group
        are left alone; a late joiner to an idle group re-materializes its
        engine lazily.
        """
        keep = self.engine_cache.resident_ids() \
            if hasattr(self.engine_cache, "resident_ids") else set()
        keep |= {id(grp.engine) for grp in self._groups.values()
                 if self._live_members(grp)}
        for grp in self._groups.values():
            eng = grp.engine
            if id(eng) in keep or not hasattr(eng, "release"):
                continue
            if not getattr(eng, "_released", True):
                eng.release()

    def run(self, max_rounds: int = 100_000) -> dict[str, RequestResult]:
        """Drive rounds until every request reaches a terminal status;
        returns results for all DONE requests (keyed by request id)."""
        for _ in range(max_rounds):
            if self.step() == 0:
                break
        return {rid: st.result for rid, st in self._requests.items()
                if st.result is not None}

    # ------------------------------------------------------------- insight
    def stats(self) -> dict:
        """Service-level accounting: engine- and estimate-cache behavior,
        group count, unique device iterations vs. per-request iterations
        consumed."""
        consumed = sum(st.result.iterations for st in self._requests.values()
                       if st.result is not None and not st.from_cache)
        return {
            "requests": len(self._requests),
            "groups": len(self._groups),
            "engine_cache": self.engine_cache.stats(),
            "estimate_cache": self.estimate_cache.stats(),
            "unique_iterations": sum(g.cursor for g in self._groups.values()),
            "consumed_iterations": consumed,
        }
