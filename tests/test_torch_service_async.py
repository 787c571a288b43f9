"""The port's async serving front end (``repro_torch.service.async_loop``,
``qos`` and ``frontend``) against the JAX package's: the QoS policy,
backpressure and shedding, cancellation, the dispatcher's supervision,
bitwise equality with the round scheduler, and the HTTP surface on
``127.0.0.1:0``.

The port's engines run on the CPU (``device="cpu"``). Every sample is a
deterministic function of ``(seed, iteration id)``, so whatever order QoS
dispatches groups in, the async service reproduces the round scheduler's
estimates, and the JAX package's at the f32 tolerance.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.graph import generators as ref_gen  # noqa: E402
from repro.resilience import faults as ref_faults  # noqa: E402
from repro.service import AsyncCountingService as RefAsync  # noqa: E402
from repro.service import CountRequest as RefRequest  # noqa: E402
from repro.service import QoS as RefQoS  # noqa: E402
from repro.service.qos import FairScheduler as RefFair  # noqa: E402
from repro.service.qos import GroupView as RefGroupView  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.resilience.retry import RetryPolicy  # noqa: E402
from repro_torch.service import (AdmissionQueue,  # noqa: E402
                                 AsyncCountingService, CountingService,
                                 CountRequest, EngineCache, EstimateCache,
                                 FairScheduler, QoS, QoSClass, RequestStatus)
from repro_torch.service.async_loop import TERMINAL_STATUSES  # noqa: E402
from repro_torch.service.qos import (SHED_CLOSED, SHED_MEMORY,  # noqa: E402
                                     SHED_QUEUE_FULL, GroupView)

INF = float("inf")
F32_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _clean_state():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    faults.clear_plan()
    ref_faults.clear_plan()


def _graph(n=30, deg=4.0, seed=0):
    return generators.erdos_renyi(n, deg, seed=seed)


def _asvc(tmp_path, name="async", **kw):
    kw.setdefault("round_size", 4)
    kw.setdefault("default_max_iters", 64)
    kw.setdefault("idle_wait_s", 0.01)
    return AsyncCountingService(ledger_root=str(tmp_path / name),
                                device="cpu", **kw)


def _gv(key, rank, deadline=INF, tenants=(("t", 1.0),)):
    return GroupView(key=key, rank=rank, deadline=deadline, tenants=tenants)


class TestQoS:
    def test_coercion_and_defaults(self):
        q = QoS(klass="deadline")
        assert q.klass is QoSClass.DEADLINE and q.deadline_s == 30.0
        assert QoS().klass is QoSClass.INTERACTIVE

    def test_validation(self):
        for bad in (dict(weight=0.0), dict(deadline_s=-1.0),
                    dict(klass="platinum")):
            with pytest.raises(ValueError):
                QoS(**bad)


class TestFairScheduler:
    def test_strict_class_priority_and_edf(self):
        pol = FairScheduler()
        b = _gv("b", QoSClass.BATCH.rank)
        i = _gv("i", QoSClass.INTERACTIVE.rank)
        d = _gv("d", QoSClass.DEADLINE.rank, deadline=99.0)
        assert pol.pick([b, i, d]) is d
        assert pol.pick([b, i]) is i
        early = _gv("early", 0, deadline=10.0, tenants=(("a", 1.0),))
        late = _gv("late", 0, deadline=20.0, tenants=(("b", 1.0),))
        assert pol.pick([late, early]) is early

    def test_fifo_on_exact_ties(self):
        pol = FairScheduler()
        a = _gv("a", 2, tenants=(("t1", 1.0),))
        b = _gv("b", 2, tenants=(("t2", 1.0),))
        assert pol.pick([a, b]) is a and pol.pick([b, a]) is b

    def test_picks_equal_the_reference_policy(self):
        """Under one seeded contention pattern both policies pick the same
        groups and end with the same tenant virtual times."""
        rng = np.random.default_rng(4)
        pol, ref = FairScheduler(), RefFair()
        tenants = [("alice", 2.0), ("bob", 1.0), ("carol", 0.5)]
        for _ in range(60):
            picks = rng.choice(len(tenants), size=2, replace=False)
            rank = int(rng.integers(1, 3))
            mine = [_gv(f"g{j}", rank, tenants=(tenants[j],))
                    for j in picks]
            theirs = [RefGroupView(key=f"g{j}", rank=rank, deadline=INF,
                                   tenants=(tenants[j],)) for j in picks]
            a, b = pol.pick(mine), ref.pick(theirs)
            assert a.key == b.key
            cost = int(rng.integers(1, 9))
            pol.charge(a.tenants, cost)
            ref.charge(b.tenants, cost)
        assert pol.virtual_times() == ref.virtual_times()

    def test_weighted_fair_share_is_proportional(self):
        pol = FairScheduler()
        heavy = _gv("heavy", 2, tenants=(("heavy", 2.0),))
        light = _gv("light", 2, tenants=(("light", 1.0),))
        wins = {"heavy": 0, "light": 0}
        for _ in range(30):
            gv = pol.pick([heavy, light])
            wins[gv.key] += 1
            pol.charge(gv.tenants, 8)
        assert wins["heavy"] == 2 * wins["light"]

    def test_newcomer_starts_at_floor_no_banked_credit(self):
        pol = FairScheduler()
        pol.charge([("old", 1.0)], 100)
        old = _gv("old", 1, tenants=(("old", 1.0),))
        new = _gv("new", 1, tenants=(("new", 1.0),))
        pol.charge([("new", 1.0)], 8)
        assert pol.pick([new, old]) is old
        assert pol.virtual_times()["new"] > 100.0


class TestAdmissionQueue:
    def test_bounded_offer_and_drain(self):
        q = AdmissionQueue(2)
        assert q.offer("a") is None and q.offer("b") is None
        assert q.offer("c") == SHED_QUEUE_FULL
        assert q.drain() == ["a", "b"] and len(q) == 0
        assert q.offer("c") is None
        with pytest.raises(ValueError):
            AdmissionQueue(0)


class TestBackpressure:
    def test_queue_full_sheds_with_reason(self, tmp_path):
        svc = _asvc(tmp_path, max_queue_depth=1)    # dispatcher not started
        svc.add_graph("g", _graph())
        r1 = svc.submit(CountRequest("g", "u3", max_iters=4))
        r2 = svc.submit(CountRequest("g", "u3", max_iters=4, seed=1))
        assert svc.status(r1) is RequestStatus.PENDING
        assert svc.status(r2) is RequestStatus.SHED
        assert svc.shed_reason(r2) == SHED_QUEUE_FULL
        assert svc.shed_reason(r1) is None
        with pytest.raises(RuntimeError):
            svc.result(r2)
        assert svc.wait([r2], timeout=5.0)
        assert svc.stats()["shed"] == 1

    @pytest.mark.parametrize("tname,budget", [("u5", 1), ("u7", 1 << 10)])
    def test_memory_budget_sheds_at_admission_as_the_reference(
            self, tmp_path, tname, budget):
        """Admission runs the executor's memory model only (no build), and
        sheds exactly where the JAX package's model does."""
        g = _graph()
        svc = _asvc(tmp_path, memory_budget_bytes=budget)
        svc.add_graph("g", g)
        rid = svc.submit(CountRequest("g", tname, max_iters=4))
        ref = RefAsync(ledger_root=str(tmp_path / "ref"),
                       memory_budget_bytes=budget)
        ref.add_graph("g", ref_gen.erdos_renyi(30, 4.0, seed=0))
        rrid = ref.submit(RefRequest("g", tname, max_iters=4))
        assert svc.status(rid).value == ref.status(rrid).value
        assert svc.shed_reason(rid) == ref.shed_reason(rrid)
        assert svc.engine_cache.stats()["builds"] == 0
        if svc.status(rid) is RequestStatus.SHED:
            assert svc.shed_reason(rid) == SHED_MEMORY

    def test_closed_service_sheds(self, tmp_path):
        svc = _asvc(tmp_path)
        svc.add_graph("g", _graph())
        svc.start()
        svc.close()
        rid = svc.submit(CountRequest("g", "u3", max_iters=4))
        assert svc.status(rid) is RequestStatus.SHED
        assert svc.shed_reason(rid) == SHED_CLOSED

    def test_saturated_queue_never_deadlocks(self, tmp_path):
        svc = _asvc(tmp_path, max_queue_depth=2)
        svc.add_graph("g", _graph(seed=13))
        with svc:
            rids = [svc.submit(CountRequest("g", "u3", max_iters=4,
                                            seed=i % 2),
                               qos=QoS(tenant=f"t{i % 3}"))
                    for i in range(12)]
            assert svc.wait(rids, timeout=180.0)
        statuses = {svc.status(r) for r in rids}
        assert statuses <= {RequestStatus.DONE, RequestStatus.SHED}
        assert RequestStatus.DONE in statuses
        assert svc._thread is None


class TestAsyncScheduling:
    def test_async_matches_sync_bitwise_and_the_reference(self, tmp_path):
        g = _graph(36, 4.0, seed=11)
        cache = EngineCache()
        reqs = [dict(template="u3", rel_stderr=0.2, seed=3),
                dict(template="path4", max_iters=12, seed=4),
                dict(template="u3", rel_stderr=0.2, seed=3)]
        sync = CountingService(ledger_root=str(tmp_path / "sync"),
                               round_size=4, engine_cache=cache,
                               device="cpu")
        sync.add_graph("g", g)
        srids = [sync.submit(CountRequest("g", **r)) for r in reqs]
        sync.run()
        asvc = _asvc(tmp_path, engine_cache=cache)
        asvc.add_graph("g", g)
        with asvc:
            arids = [asvc.submit(CountRequest("g", **r),
                                 qos=QoS(tenant=f"t{i}"))
                     for i, r in enumerate(reqs)]
            assert asvc.drain(timeout=180.0)
        ref = RefAsync(ledger_root=str(tmp_path / "ref"), round_size=4,
                       default_max_iters=64, idle_wait_s=0.01)
        ref.add_graph("g", ref_gen.erdos_renyi(36, 4.0, seed=11))
        with ref:
            rrids = [ref.submit(RefRequest("g", **r),
                                qos=RefQoS(tenant=f"t{i}"))
                     for i, r in enumerate(reqs)]
            assert ref.drain(timeout=180.0)
        for sr, ar, rr in zip(srids, arids, rrids):
            s, a, r = sync.result(sr), asvc.result(ar), ref.result(rr)
            assert a.estimate == s.estimate and a.stderr == s.stderr
            assert a.iterations == s.iterations == r.iterations
            np.testing.assert_allclose(a.estimate, r.estimate,
                                       rtol=F32_RTOL)
        assert asvc.stats()["groups"] == ref.stats()["groups"] == 2
        assert asvc.stats().keys() == ref.stats().keys()

    def test_deadline_retires_before_batch_under_contention(self, tmp_path):
        svc = _asvc(tmp_path)
        svc.add_graph("g", _graph(seed=12))
        batch = [svc.submit(CountRequest("g", "u3", max_iters=24, seed=s),
                            qos=QoS(klass="batch", tenant="etl"))
                 for s in (0, 1)]
        dl = svc.submit(CountRequest("g", "path4", max_iters=8, seed=2),
                        qos=QoS(klass="deadline", deadline_s=60.0,
                                tenant="sla"))
        with svc:
            assert svc.drain(timeout=180.0)
        order = svc.retired_order()
        assert order.index(dl) < min(order.index(r) for r in batch)
        assert svc.result(dl).iterations == 8

    def test_cancel_while_queued_is_honored(self, tmp_path):
        svc = _asvc(tmp_path)
        svc.add_graph("g", _graph())
        rid = svc.submit(CountRequest("g", "u3", max_iters=4))
        svc.cancel(rid)
        with svc:
            assert svc.drain(timeout=60.0)
        assert svc.status(rid) is RequestStatus.CANCELLED
        assert svc.stats()["groups"] == 0

    def test_sync_run_guarded_while_dispatcher_alive(self, tmp_path):
        svc = _asvc(tmp_path)
        with svc:
            with pytest.raises(RuntimeError, match="async dispatcher"):
                svc.run()

    def test_prewarm_builds_before_any_request(self, tmp_path):
        svc = _asvc(tmp_path)
        g = _graph()
        svc.add_graph("g", g)
        with svc:
            svc.prewarm("g", "u5")
            for _ in range(500):
                if svc.engine_cache.has(g, "u5", **svc.engine_kw):
                    break
                threading.Event().wait(0.01)
            assert svc.engine_cache.stats()["builds"] == 1
            rid = svc.submit(CountRequest("g", "u5", max_iters=4))
            assert svc.wait([rid], timeout=60.0)
        stats = svc.engine_cache.stats()
        assert stats["builds"] == 1 and stats["hits"] == 1


def _ent(iters):
    return {"estimate": float(iters), "stderr": 0.1,
            "rel_stderr": 0.1, "iterations": iters}


class TestEstimateCacheConcurrency:
    def test_concurrent_writers_single_instance(self, tmp_path):
        path = str(tmp_path / "est.json")
        cache = EstimateCache(path)

        def put_range(base):
            for i in range(20):
                cache.put(f"k{base + i}", _ent(base + i + 1))

        threads = [threading.Thread(target=put_range, args=(j * 20,))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
            assert not t.is_alive()
        with open(path) as f:
            json.load(f)
        assert len(EstimateCache(path)) == 80

    def test_port_and_reference_writers_share_one_file(self, tmp_path):
        from repro.service.cache import EstimateCache as RefEstimateCache
        path = str(tmp_path / "est.json")
        a, b = EstimateCache(path), RefEstimateCache(path)
        a.put("ka", _ent(4))
        b.put("kb", _ent(4))
        a.put("shared", _ent(4))
        b.put("shared", _ent(8))         # more iterations wins the merge
        a.put("shared", _ent(2))
        for fresh in (EstimateCache(path), RefEstimateCache(path)):
            assert fresh.get("ka") and fresh.get("kb")
            assert fresh.get("shared")["iterations"] == 8
            assert len(fresh) == 3


# ------------------------------------------------------------ supervision
def _chaos_graph():
    return generators.erdos_renyi(48, 5.0, seed=0)


def _async(tmp_path, **kw):
    kw.setdefault("round_size", 4)
    kw.setdefault("default_max_iters", 8)
    kw.setdefault("idle_wait_s", 0.01)
    kw.setdefault("warm_pool", False)
    kw.setdefault("ledger_root", str(tmp_path / "ledgers"))
    return AsyncCountingService(device="cpu", **kw)


def _sync_base(tmp_path, template="path3", seed=0):
    sync = CountingService(ledger_root=str(tmp_path / "sync"), round_size=4,
                           default_max_iters=8, device="cpu")
    sync.add_graph("g", _chaos_graph())
    rid = sync.submit(CountRequest("g", template, max_iters=8, seed=seed))
    return sync.run()[rid].estimate


class TestAsyncChaos:
    def test_dispatcher_crash_restarts_and_finishes(self, tmp_path):
        base = _sync_base(tmp_path)
        plan = faults.FaultPlan.parse("dispatch.loop:raise:1.0:2", seed=3)
        with faults.active_plan(plan):
            svc = _async(tmp_path / "crash")
            svc.add_graph("g", _chaos_graph())
            with svc:
                rid = svc.submit(CountRequest("g", "path3", max_iters=8))
                assert svc.wait([rid], timeout=90)
                res = svc.result(rid)
        assert res.estimate == base
        assert svc.stats()["dispatcher_crashes"] == 2

    def test_restart_budget_exhaustion_orphans_nothing(self, tmp_path):
        plan = faults.FaultPlan.parse("dispatch.loop:raise:1.0", seed=3)
        with faults.active_plan(plan):
            svc = _async(tmp_path / "dead", max_dispatcher_restarts=2)
            svc.add_graph("g", _chaos_graph())
            with svc:
                rids = [svc.submit(CountRequest("g", "path3", max_iters=8))
                        for _ in range(3)]
                assert svc.wait(rids, timeout=30)
            for rid in rids:
                st = svc._requests[rid]
                assert st.status in TERMINAL_STATUSES
                if st.status is RequestStatus.FAILED:
                    assert st.error_class == "DispatcherDead"
            rid = svc.submit(CountRequest("g", "path3", max_iters=8))
            assert svc._requests[rid].status in TERMINAL_STATUSES
        assert not svc.resilience_state()["dispatcher"]["alive"]

    def test_mixed_chaos_every_request_terminal(self, tmp_path):
        base = {tpl: _sync_base(tmp_path / tpl, tpl, seed=1)
                for tpl in ("path3", "star3")}
        plan = faults.FaultPlan.parse(
            "kernel.dispatch:raise:0.25,engine.build:raise:0.3:2,"
            "dispatch.loop:raise:1.0:1", seed=13)
        with faults.active_plan(plan):
            svc = _async(tmp_path / "mixed", degrade_after=1,
                         retry_policy=RetryPolicy(max_attempts=3,
                                                  base_delay_s=0.01,
                                                  timeout_s=30.0))
            svc.add_graph("g", _chaos_graph())
            with svc:
                rids = {}
                for i in range(8):
                    tpl = ("path3", "star3")[i % 2]
                    rids[svc.submit(CountRequest(
                        "g", tpl, max_iters=8, seed=1))] = tpl
                assert svc.wait(list(rids), timeout=120)
        for rid, tpl in rids.items():
            st = svc._requests[rid]
            assert st.status in TERMINAL_STATUSES, f"{rid} orphaned"
            if st.status is RequestStatus.DONE and not st.from_cache:
                assert st.result.estimate == base[tpl]
        assert sum(v["fired"] for v in plan.stats().values()) > 0


# ------------------------------------------------------------------- HTTP
def _post(base, payload, timeout=120):
    req = urllib.request.Request(
        base + "/count", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.load(resp)


class TestHTTPFrontend:
    def test_count_result_and_health_end_to_end(self, tmp_path):
        from repro.obs.validate import validate_snapshot as ref_validate
        from repro_torch.obs.validate import validate_snapshot
        from repro_torch.service.frontend import serve_forever
        g = _graph(seed=14)
        svc = _asvc(tmp_path, name="http")
        svc.add_graph("g", g)
        httpd = serve_forever(svc, "127.0.0.1", 0)   # ephemeral port
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, payload = _post(base, {
                "graph": "g", "templates": ["u3", [[0, 1], [1, 2], [1, 3]]],
                "max_iters": 4, "qos": {"class": "interactive",
                                        "tenant": "alice"},
                "wait": True, "timeout_s": 120})
            assert code == 200
            ents = payload["requests"]
            assert [e["status"] for e in ents] == ["done", "done"]
            assert ents[0]["result"]["iterations"] == 4
            code, again = _get(f"{base}/result/{ents[0]['id']}")
            assert again["result"]["estimate"] == \
                ents[0]["result"]["estimate"]
            code, health = _get(base + "/healthz")
            assert code == 200 and health["ok"]
            assert health["resilience"]["dispatcher"]["alive"]
            code, snap = _get(base + "/metrics.json")
            validate_snapshot(snap)
            ref_validate(snap)
            assert any("qos=" in k for k in snap["histograms"])
        finally:
            httpd.shutdown()
            svc.close()
        # the same request through the round scheduler
        sync = CountingService(ledger_root=str(tmp_path / "s"),
                               round_size=4, device="cpu")
        sync.add_graph("g", g)
        rid = sync.submit(CountRequest("g", "u3", max_iters=4))
        assert sync.run()[rid].estimate == ents[0]["result"]["estimate"]

    def test_bad_template_400_unknown_route_404_and_500(self, tmp_path):
        from repro_torch.service.frontend import make_server
        svc = _asvc(tmp_path, name="http2")
        svc.add_graph("g", _graph())
        svc.start()
        httpd = make_server(svc, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, {"templates": ["no-such-template"],
                             "max_iters": 4}, timeout=30)
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(base + "/nope")
            assert ei.value.code == 404
            plan = faults.FaultPlan(
                [faults.FaultSpec("http.handler", match="POST", times=1)],
                seed=2)
            with faults.active_plan(plan):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _post(base, {"graph": "g", "templates": ["path3"],
                                 "max_iters": 4}, timeout=30)
                assert ei.value.code == 500
                body = json.loads(ei.value.read())
                assert body["error_class"] == "InjectedFault"
                assert body["request_id"].startswith("h")
                code, _ = _post(base, {"graph": "g", "templates": ["path3"],
                                       "max_iters": 4}, timeout=60)
                assert code == 200         # the pool survived
        finally:
            httpd.shutdown()
            svc.close()

    def test_wait_clamped_and_poll_until_done(self, tmp_path):
        from repro_torch.service.frontend import make_server
        svc = _asvc(tmp_path, name="http3", warm_pool=False)
        svc.add_graph("g", _graph())
        httpd = make_server(svc, "127.0.0.1", 0, max_wait_s=0.05)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            # the dispatcher is not started yet: the handler's wait is
            # clamped and the request is accepted, not finished
            code, payload = _post(base, {"graph": "g", "templates": ["u3"],
                                         "max_iters": 4, "timeout_s": 600})
            assert code == 202
            (ent,) = payload["requests"]
            svc.start()
            assert svc.wait([ent["id"]], timeout=120)
            code, out = _get(f"{base}/result/{ent['id']}")
            assert code == 200 and out["status"] == "done"
        finally:
            httpd.shutdown()
            svc.close()
