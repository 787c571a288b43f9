"""The port's counting service (``repro_torch.service``) against the JAX
package's (``repro.service``): the round scheduler, the engine and
estimate caches, adaptive stopping, group sharing, resume, and failure
containment (retry, watchdog, degradation ladder, circuit breaker).

The same numpy-seeded graphs and requests go through both packages, the
port's engines on the CPU (``device="cpu"``: the kernels' plain versions).
Samples are deterministic functions of ``(seed, iteration id)`` in both,
so estimates agree at the f32 tolerance and iteration counts exactly; the
estimate cache's file and the runner's ledgers are the same bytes, so
either package serves or resumes the other's.
"""

import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import build_engine as ref_build_engine  # noqa: E402
from repro.core import get_template as ref_get_template  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.resilience import faults as ref_faults  # noqa: E402
from repro.resilience.retry import RetryPolicy as RefRetryPolicy  # noqa: E402
from repro.service import CountingService as RefService  # noqa: E402
from repro.service import CountRequest as RefRequest  # noqa: E402
from repro_torch.core import (build_engine, count_subgraphs_exact,  # noqa: E402
                              get_template)
from repro_torch.graph import generators  # noqa: E402
from repro_torch.obs import metrics as _metrics  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.resilience.degradation import (  # noqa: E402
    BreakerBoard, CircuitBreaker, DegradationState)
from repro_torch.resilience.retry import (DispatchTimeout,  # noqa: E402
                                          RetryPolicy, run_with_timeout)
from repro_torch.service import (CountingService, CountRequest,  # noqa: E402
                                 EngineCache, EstimateCache, RequestStatus,
                                 RunningStat)

F32_RTOL = 1e-6
TEMPLATES = ("path3", "star4", "u5", "u7")


@pytest.fixture(autouse=True)
def _clean_state():
    """Partitionable threefry (the port's coloring stream) and no fault
    plan left behind by a test that dies mid-chaos."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)
    faults.clear_plan()
    ref_faults.clear_plan()


def _graphs(n=120, deg=4.0, seed=0):
    """The same graph in both packages (the generators are copies)."""
    return generators.erdos_renyi(n, deg, seed=seed), \
        ref_gen.erdos_renyi(n, deg, seed=seed)


def _graph(n=30, deg=4.0, seed=0):
    return generators.erdos_renyi(n, deg, seed=seed)


def _svc(tmp_path, name="svc", **kw):
    kw.setdefault("round_size", 8)
    kw.setdefault("default_max_iters", 64)
    return CountingService(ledger_root=str(tmp_path / name), device="cpu",
                           **kw)


def _ref_svc(tmp_path, name="ref", **kw):
    kw.setdefault("round_size", 8)
    kw.setdefault("default_max_iters", 64)
    return RefService(ledger_root=str(tmp_path / name), **kw)


def _counter_total(prefix: str, **labels) -> float:
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(v for k, v in _metrics.snapshot()["counters"].items()
               if k.split("{")[0] == prefix and all(w in k for w in want))


# ------------------------------------------------- the port against repro
def test_generators_give_the_same_graph():
    g, rg = _graphs()
    assert g.fingerprint == rg.fingerprint
    np.testing.assert_array_equal(g.indices, rg.indices)


@pytest.mark.parametrize("tname", TEMPLATES)
def test_fixed_budget_requests_equal_reference(tmp_path, tname):
    g, rg = _graphs()
    svc, ref = _svc(tmp_path), _ref_svc(tmp_path)
    svc.add_graph("g", g)
    ref.add_graph("g", rg)
    rid = svc.submit(CountRequest("g", tname, max_iters=12, seed=3))
    rrid = ref.submit(RefRequest("g", tname, max_iters=12, seed=3))
    got, want = svc.run()[rid], ref.run()[rrid]
    assert got.iterations == want.iterations == 12
    np.testing.assert_allclose(got.estimate, want.estimate, rtol=F32_RTOL)
    np.testing.assert_allclose(got.stderr, want.stderr, rtol=F32_RTOL)
    np.testing.assert_allclose(got.ci95, want.ci95, rtol=F32_RTOL)
    assert svc.stats().keys() == ref.stats().keys()
    assert svc.stats()["groups"] == ref.stats()["groups"] == 1


@pytest.mark.parametrize("target", [0.2, 0.08])
def test_adaptive_requests_equal_reference(tmp_path, target):
    """Both packages stop each request at the same iteration, and requests
    that spell one tree differently share one group in both."""
    g, rg = _graphs()
    reqs = [dict(template="u5", rel_stderr=target, seed=1),
            dict(template="path4", rel_stderr=target, seed=1),
            dict(template=[(0, 1), (1, 2), (2, 3)], rel_stderr=target,
                 seed=1)]                  # path4 relabelled: shares
    svc, ref = _svc(tmp_path, round_size=4), _ref_svc(tmp_path, round_size=4)
    svc.add_graph("g", g)
    ref.add_graph("g", rg)
    rids = [svc.submit(CountRequest("g", **r)) for r in reqs]
    rrids = [ref.submit(RefRequest("g", **r)) for r in reqs]
    got, want = svc.run(), ref.run()
    for a, b in zip(rids, rrids):
        assert got[a].iterations == want[b].iterations
        assert got[a].target_met == want[b].target_met
        np.testing.assert_allclose(got[a].estimate, want[b].estimate,
                                   rtol=F32_RTOL)
    assert got[rids[1]].estimate == got[rids[2]].estimate
    assert svc.stats()["groups"] == ref.stats()["groups"] == 2
    assert svc.stats()["unique_iterations"] == \
        ref.stats()["unique_iterations"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_results_file_serves_the_other_package(tmp_path, writer):
    g, rg = _graphs()
    path = str(tmp_path / "estimates.json")
    ref_first = writer == "reference"
    first = _ref_svc(tmp_path, estimate_cache=path) if ref_first \
        else _svc(tmp_path, estimate_cache=path)
    first.add_graph("g", rg if ref_first else g)
    rid = first.submit((RefRequest if ref_first else CountRequest)(
        "g", "u5", max_iters=8))
    done = first.run()[rid]
    # a new process of the other package, on the file the first wrote
    second = _svc(tmp_path, "b", estimate_cache=path) if ref_first \
        else _ref_svc(tmp_path, "b", estimate_cache=path)
    req_b = CountRequest if ref_first else RefRequest
    second.add_graph("other", g if ref_first else rg)
    rid2 = second.submit(req_b("other", "u5", max_iters=8))
    assert second.status(rid2).value == "done"
    res = second.result(rid2)
    assert res.from_cache and res.estimate == done.estimate
    assert res.iterations == done.iterations
    assert second.engine_cache.stats()["builds"] == 0


@pytest.mark.parametrize("first_pkg", ["reference", "port"])
def test_ledger_root_resumes_across_packages(tmp_path, first_pkg):
    """One round in one package, then the other package's service on the
    same ledger root computes only the missing iterations and ends where a
    never-interrupted service does."""
    g, rg = _graphs()
    root = str(tmp_path / "ledgers")
    if first_pkg == "reference":
        a = RefService(ledger_root=root, round_size=4)
        a.add_graph("g", rg)
        a.submit(RefRequest("g", "u5", max_iters=12, seed=2))
    else:
        a = CountingService(ledger_root=root, round_size=4, device="cpu")
        a.add_graph("g", g)
        a.submit(CountRequest("g", "u5", max_iters=12, seed=2))
    a.step()                              # 4 iterations, then "killed"
    if first_pkg == "reference":
        cache = EngineCache()
        eng = cache.get(g, "u5", device="cpu")
        b = CountingService(ledger_root=root, round_size=4, device="cpu",
                            engine_cache=cache)
        b.add_graph("g", g)
        rid = b.submit(CountRequest("g", "u5", max_iters=12, seed=2))
    else:
        from repro.service import EngineCache as RefEngineCache
        cache = RefEngineCache()
        eng = cache.get(rg, "u5")
        b = RefService(ledger_root=root, round_size=4, engine_cache=cache)
        b.add_graph("g", rg)
        rid = b.submit(RefRequest("g", "u5", max_iters=12, seed=2))
    res = b.run()[rid]
    assert eng.n_colorings_dispatched == 8     # only the missing ones
    straight = _ref_svc(tmp_path, "straight", round_size=4)
    straight.add_graph("g", rg)
    sid = straight.submit(RefRequest("g", "u5", max_iters=12, seed=2))
    want = straight.run()[sid]
    assert res.iterations == 12
    np.testing.assert_allclose(res.estimate, want.estimate, rtol=F32_RTOL)


@pytest.mark.parametrize("form", ["0-1,1-2,1-3", "0-1,1-2,2-3,2-4@2",
                                  " 3-0, 0-1 ,1-2@1"])
def test_template_spec_serializes_as_the_reference(form):
    from repro.core.templates import TemplateSpec as RefSpec
    from repro_torch import api
    from repro_torch.core.templates import TemplateSpec
    spec = TemplateSpec.from_edge_string(form, name="t")
    ref = RefSpec.from_edge_string(form, name="t")
    assert spec.to_dict() == ref.to_dict()
    assert spec.to_json() == ref.to_json()
    assert spec.canonical_hash == ref.canonical_hash
    back = TemplateSpec.from_dict(ref.to_dict())
    assert back == spec and back.display_name == "t"
    assert TemplateSpec(edges=spec.edges).display_name == \
        RefSpec(edges=ref.edges).display_name
    assert api.template(spec) is spec
    assert api.template("u5").canonical_hash == \
        RefSpec.of("u5").canonical_hash
    with pytest.raises(ValueError, match="u-v"):
        TemplateSpec.from_edge_string("0-1,12")


# ------------------------------------------------------------- primitives
class TestRunningStat:
    def test_matches_numpy(self):
        xs = [3.0, 1.5, 4.25, -2.0, 7.5, 0.0]
        st = RunningStat()
        for x in xs:
            st.update(x)
        arr = np.asarray(xs)
        assert st.mean == pytest.approx(arr.mean())
        assert st.variance == pytest.approx(arr.var(ddof=1))
        assert st.stderr == pytest.approx(arr.std(ddof=1) / math.sqrt(6))


class TestEngineCache:
    def test_keys_differ_by_device_and_name_dtypes(self):
        g = _graph()
        cpu = EngineCache.key(g, "u5", "pgbsc", "optimized", device="cpu")
        cuda = EngineCache.key(g, "u5", "pgbsc", "optimized", device="cuda")
        assert cpu != cuda
        # absent or None means the engine default, the card
        assert EngineCache.key(g, "u5", "pgbsc", "optimized") == cuda
        assert EngineCache.key(g, "u5", "pgbsc", "optimized",
                               device=None) == cuda
        assert EngineCache.key(g, "u5", "pgbsc", "optimized",
                               device=torch.device("cpu")) == cpu
        k = EngineCache.key(g, "u5", "pgbsc", "optimized", device="cpu",
                            dtype=torch.bfloat16)
        assert ("dtype", "torch.bfloat16") in k[4]

    def test_cpu_engine_never_serves_a_cuda_lookup(self):
        cache = EngineCache()
        g = _graph()
        eng = cache.get(g, "u3", device="cpu")
        assert eng.device == torch.device("cpu")
        assert cache.has(g, "u3", device="cpu")
        assert not cache.has(g, "u3", device="cuda")
        assert not cache.has(g, "u3")

    def test_hit_miss_and_content_keying(self):
        cache = EngineCache()
        g1, g2, g3 = _graph(seed=1), _graph(seed=1), _graph(seed=2)
        e1 = cache.get(g1, "u3", device="cpu")
        assert cache.stats() == {"hits": 0, "misses": 1, "builds": 1,
                                 "evictions": 0, "resident": 1}
        assert cache.get(g2, "u3", device="cpu") is e1
        from repro_torch.core.templates import TemplateSpec
        u3 = TemplateSpec.of("u3")
        renamed = TemplateSpec(edges=u3.edges, root=u3.root, name="other")
        assert cache.get(g1, renamed, device="cpu") is e1
        assert cache.get(g1, "u3", plan="plain", device="cpu") is not e1
        assert cache.get(g3, "u3", device="cpu") is not e1
        assert cache.hits == 2 and cache.builds == 3

    def test_lru_eviction_releases(self):
        cache = EngineCache(max_entries=2)
        g = _graph()
        e_u3 = cache.get(g, "u3", device="cpu")
        e_p4 = cache.get(g, "path4", device="cpu")
        cache.get(g, "u3", device="cpu")           # refresh u3
        cache.get(g, "u5", device="cpu")           # evicts path4
        assert len(cache) == 2 and e_p4._released
        assert cache.get(g, "u3", device="cpu") is e_u3
        cache.get(g, "path4", device="cpu")        # miss again -> rebuild
        assert cache.builds == 4 and cache.evictions == 2

    def test_service_builds_once_for_repeats(self, tmp_path):
        svc = _svc(tmp_path)
        svc.add_graph("g", _graph())
        for _ in range(3):
            svc.submit(CountRequest("g", "u3", max_iters=4))
        svc.run()
        assert svc.engine_cache.stats()["builds"] == 1
        assert svc.stats()["groups"] == 1

    def test_idle_groups_release_engine_device_state(self, tmp_path):
        svc = _svc(tmp_path, engine_cache=EngineCache(max_entries=1))
        svc.add_graph("g", _graph())
        r1 = svc.submit(CountRequest("g", "u3", max_iters=4))
        svc.run()
        (grp_u3,) = svc._groups.values()
        assert not grp_u3.engine._released       # still cache-resident
        r2 = svc.submit(CountRequest("g", "path4", max_iters=4))
        svc.run()
        assert svc._requests[r2].status is RequestStatus.DONE
        assert grp_u3.engine._released           # evicted and idle
        r3 = svc.submit(CountRequest("g", "u3", max_iters=8))
        svc.run()
        assert svc.result(r3).iterations == 8
        assert svc.result(r1).estimate == pytest.approx(
            np.mean(grp_u3.history[:4]))


class TestEstimateCache:
    def test_key_string_is_the_reference_key(self):
        from repro.service.cache import EstimateCache as RefEstimateCache
        g, rg = _graphs()
        assert EstimateCache.key(g.fingerprint, "u5", "pgbsc", "plain", 3) \
            == RefEstimateCache.key(rg.fingerprint, "u5", "pgbsc", "plain",
                                    3)

    def test_insufficient_precision_is_a_miss(self, tmp_path):
        cache = EstimateCache()
        g = _graph()
        svc1 = _svc(tmp_path, "a", estimate_cache=cache)
        svc1.add_graph("g", g)
        rid = svc1.submit(CountRequest("g", "u3", max_iters=6))
        done = svc1.run()[rid]
        svc2 = _svc(tmp_path, "b", estimate_cache=cache)
        svc2.add_graph("g", g)
        rid2 = svc2.submit(CountRequest("g", "u3", max_iters=12))
        assert svc2.status(rid2) is RequestStatus.PENDING
        res = svc2.run()[rid2]
        assert not res.from_cache and res.iterations == 12
        assert done.iterations < 12 <= cache.get(list(
            cache._mem)[0])["iterations"]

    def test_min_iters_guard_applies_to_cache_hits(self, tmp_path):
        cache = EstimateCache()
        g = _graph()
        svc1 = _svc(tmp_path, "a", estimate_cache=cache)
        svc1.add_graph("g", g)
        svc1.submit(CountRequest("g", "u3", max_iters=2))
        svc1.run()
        svc2 = _svc(tmp_path, "b", estimate_cache=cache)
        svc2.add_graph("g", g)
        rid = svc2.submit(CountRequest("g", "u3", rel_stderr=0.9,
                                       min_iters=4))
        assert svc2.status(rid) is RequestStatus.PENDING
        res = svc2.run()[rid]
        assert res.iterations >= 4 and not res.from_cache


class TestAdaptiveStopping:
    def test_tighter_target_runs_longer_same_stream(self, tmp_path):
        g = _graph(40, 4.0, seed=3)
        svc = _svc(tmp_path, round_size=16, default_max_iters=600)
        svc.add_graph("g", g)
        rid_loose = svc.submit(CountRequest("g", "u3", rel_stderr=0.2))
        rid_tight = svc.submit(CountRequest("g", "u3", rel_stderr=0.05))
        res = svc.run()
        loose, tight = res[rid_loose], res[rid_tight]
        assert loose.target_met and tight.target_met
        assert tight.iterations > loose.iterations
        exact = count_subgraphs_exact(g, get_template("u3"))
        assert tight.estimate == pytest.approx(exact, rel=0.2)

    def test_estimate_is_prefix_mean_of_engine_samples(self, tmp_path):
        g = _graph(seed=4)
        svc = _svc(tmp_path)
        svc.add_graph("g", g)
        rid = svc.submit(CountRequest("g", "u3", rel_stderr=0.1, seed=5))
        res = svc.run()[rid]
        eng = build_engine(g, get_template("u3"), "pgbsc", device="cpu")
        manual = np.asarray(eng.estimate(n_iters=res.iterations,
                                         seed=5)["samples"])
        assert res.estimate == pytest.approx(float(manual.mean()), rel=1e-6)
        want_se = float(manual.std(ddof=1)) / math.sqrt(len(manual))
        assert res.stderr == pytest.approx(want_se, rel=1e-6)

    def test_cap_bounds_adaptive_requests(self, tmp_path):
        svc = _svc(tmp_path, default_max_iters=12, round_size=8)
        svc.add_graph("g", _graph(seed=6))
        rid = svc.submit(CountRequest("g", "u3", rel_stderr=1e-9))
        res = svc.run()[rid]
        assert res.iterations == 12 and not res.target_met
        assert svc.stats()["unique_iterations"] == 12


class TestGroupBatching:
    def test_shared_group_equals_solo_run_with_no_extra_device_work(
            self, tmp_path):
        g = _graph(36, 4.0, seed=7)
        req = dict(template="path4", rel_stderr=0.15, seed=2)
        solo_cache = EngineCache()
        solo = _svc(tmp_path, "solo", engine_cache=solo_cache)
        solo.add_graph("g", g)
        rid = solo.submit(CountRequest("g", **req))
        solo_res = solo.run()[rid]
        solo_cols = solo_cache.get(g, "path4",
                                   device="cpu").n_colorings_dispatched
        shared_cache = EngineCache()
        shared = _svc(tmp_path, "shared", engine_cache=shared_cache)
        shared.add_graph("g", g)
        rids = [shared.submit(CountRequest("g", **req)) for _ in range(3)]
        shared_res = shared.run()
        for r in rids:
            assert shared_res[r].estimate == solo_res.estimate
            assert shared_res[r].iterations == solo_res.iterations
        assert shared_cache.get(g, "path4", device="cpu"
                                ).n_colorings_dispatched == solo_cols
        assert shared.stats()["groups"] == 1

    def test_different_seeds_do_not_share(self, tmp_path):
        svc = _svc(tmp_path)
        svc.add_graph("g", _graph())
        svc.submit(CountRequest("g", "u3", max_iters=4, seed=0))
        svc.submit(CountRequest("g", "u3", max_iters=4, seed=1))
        svc.run()
        assert svc.stats()["groups"] == 2
        assert svc.engine_cache.stats()["builds"] == 1


class TestLifecycleAndResume:
    def test_status_transitions_and_cancel(self, tmp_path):
        svc = _svc(tmp_path)
        svc.add_graph("g", _graph())
        rid = svc.submit(CountRequest("g", "u3", max_iters=32))
        dead = svc.submit(CountRequest("g", "path4", max_iters=32))
        assert svc.status(rid) is RequestStatus.PENDING
        svc.cancel(dead)
        svc.run()
        assert svc.status(rid) is RequestStatus.DONE
        assert svc.status(dead) is RequestStatus.CANCELLED
        with pytest.raises(RuntimeError):
            svc.result(dead)

    def test_unknown_engine_fails_request_not_service(self, tmp_path):
        svc = _svc(tmp_path)
        svc.add_graph("g", _graph())
        bad = svc.submit(CountRequest("g", "u3", max_iters=4,
                                      engine="nonsense"))
        ok = svc.submit(CountRequest("g", "u3", max_iters=4))
        res = svc.run()
        assert svc.status(bad) is RequestStatus.FAILED
        assert bad not in res and ok in res

    def test_precision_contract_required(self, tmp_path):
        svc = _svc(tmp_path)
        svc.add_graph("g", _graph())
        with pytest.raises(ValueError):
            svc.submit(CountRequest("g", "u3"))
        with pytest.raises(KeyError):
            svc.submit(CountRequest("nograph", "u3", max_iters=4))

    def test_cancel_mid_dispatch_flushes_ledger_and_drains_group(
            self, tmp_path):
        g = _graph(seed=9)
        cache = EngineCache()
        eng = cache.get(g, "u3", device="cpu")
        inner = eng.count_iterations_batch
        dispatched: list[int] = []
        svc = CountingService(ledger_root=str(tmp_path / "led"),
                              engine_cache=cache, round_size=4,
                              device="cpu")

        def spy(iterations, **kw):
            dispatched.extend(int(i) for i in iterations)
            svc.cancel(rid)
            return inner(iterations, **kw)

        eng.count_iterations_batch = spy
        svc.add_graph("g", g)
        rid = svc.submit(CountRequest("g", "u3", max_iters=12))
        svc.step()
        assert svc.status(rid) is RequestStatus.CANCELLED
        (grp,) = svc._groups.values()
        assert sorted(grp.runner.completed_iterations()) == [0, 1, 2, 3]
        svc.run()
        assert dispatched == [0, 1, 2, 3]
        r2 = svc.submit(CountRequest("g", "u3", max_iters=4))
        svc.run()
        assert svc.result(r2).iterations == 4
        assert dispatched == [0, 1, 2, 3]


def test_no_engine_buffer_outlives_a_dispatch():
    """An abandoned dispatch and its retry share nothing they write: the
    tensors an engine holds (its operands, split tables and chunk walks)
    are the same objects with the same contents before and after a
    ``count_iterations_batch`` call."""
    eng = build_engine(generators.grid_2d(32, 32), "u13", "pgbsc",
                       device="cpu", memory_budget_bytes=16 << 20)
    assert eng.schedule.chunk_map       # the chunked walk is covered too

    def walk(x, path, out):
        if isinstance(x, torch.Tensor):
            out[path] = (id(x), x.clone())
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,), out)
        elif isinstance(x, (tuple, list)):
            for j, v in enumerate(x):
                walk(v, path + (j,), out)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f), path + (f,), out)

    def held():
        out = {}
        for name in ("_spmm_prep", "_fused_prep", "_nbr", "_mask",
                     "_order_dev", "_inv_dev", "_splits", "_chunk_walks"):
            walk(getattr(eng, name), (name,), out)
        return out

    before = held()
    assert before
    eng.count_iterations_batch(range(2), seed=1)
    after = held()
    assert after.keys() == before.keys()
    for k, (i, t) in before.items():
        assert after[k][0] == i
        torch.testing.assert_close(after[k][1], t, rtol=0, atol=0)


# ------------------------------------------------------ failure containment
def _service(tmp_path, **kw):
    kw.setdefault("round_size", 4)
    kw.setdefault("default_max_iters", 8)
    kw.setdefault("ledger_root", str(tmp_path / "ledgers"))
    return CountingService(device="cpu", **kw)


def _run_one(svc, graph, template="path3", **req_kw):
    svc.add_graph("g", graph)
    req_kw.setdefault("max_iters", 8)
    rid = svc.submit(CountRequest("g", template, **req_kw))
    svc.run()
    return rid, svc._requests[rid]


def _ref_base(tmp_path, template="path3", **svc_kw):
    """The reference service's clean estimate of one request."""
    _, rg = _graphs(48, 5.0, seed=0)
    svc_kw.setdefault("round_size", 4)
    svc_kw.setdefault("default_max_iters", 8)
    ref = RefService(ledger_root=str(tmp_path / "refled"), **svc_kw)
    ref.add_graph("g", rg)
    rid = ref.submit(RefRequest("g", template, max_iters=8))
    return ref.run()[rid].estimate


@pytest.fixture(scope="module")
def graph():
    return _graphs(48, 5.0, seed=0)[0]


class TestWatchdogAndLadderPrimitives:
    def test_watchdog_runs_inline_and_reraises(self):
        assert run_with_timeout(lambda c: 7, None) == 7
        with pytest.raises(KeyError):
            run_with_timeout(lambda c: {}["missing"], 5.0)

    def test_backoff_shape(self):
        pol = RetryPolicy(base_delay_s=0.1, max_delay_s=0.5, jitter=0.0)
        assert [pol.delay(a) for a in (1, 2, 3, 4)] == [0.1, 0.2, 0.4, 0.5]
        with pytest.raises(ValueError):
            RetryPolicy(max_attempts=0)

    def test_ladder_rungs_are_the_ports(self):
        lad = DegradationState(step_after=1)
        base = {"spmm_method": "bsr", "dtype": torch.bfloat16,
                "device": "cpu"}
        assert lad.apply(base) == base            # level 0: untouched
        assert lad.on_failure() and lad.level_name == "unfused"
        # the port's engine fuses by default, so level 1 must say False
        assert lad.apply(base)["fuse_spmm_ema"] is False
        assert lad.apply(base)["dtype"] is torch.bfloat16
        assert lad.on_failure() and lad.level_name == "xla"
        kw = lad.apply(base)
        assert kw["spmm_method"] == "gather"
        assert kw["fuse_spmm_ema"] is False
        assert kw["dtype"] is torch.float32
        assert lad.apply({"dtype": torch.float32})["dtype"] is torch.float32

    def test_ladder_promotes_one_rung_per_cooldown(self):
        clk = [0.0]
        lad = DegradationState(step_after=1, cooldown_s=5.0,
                               clock=lambda: clk[0])
        lad.on_failure()
        lad.on_failure()
        assert lad.level == 2 and not lad.maybe_promote()
        clk[0] = 6.0
        assert lad.maybe_promote() and lad.level == 1
        assert not lad.maybe_promote()
        clk[0] = 12.0
        assert lad.maybe_promote() and lad.level == 0

    def test_breaker_state_machine_and_board(self):
        clk = [0.0]
        br = CircuitBreaker(threshold=2, cooldown_s=5.0,
                            clock=lambda: clk[0])
        br.on_failure()
        assert br.state == br.CLOSED and br.allow()
        br.on_failure()
        assert br.state == br.OPEN and not br.allow()
        clk[0] = 6.0
        assert br.allow() and br.state == br.HALF_OPEN and not br.allow()
        br.on_success()
        assert br.state == br.CLOSED
        board = BreakerBoard(threshold=1, cooldown_s=60.0)
        board.get(("k",), label="grp").on_failure()
        assert board.snapshot()["unhealthy"]["grp"]["state"] == "open"


class TestSchedulerChaos:
    def test_retried_dispatch_equals_reference(self, tmp_path, graph):
        base = _ref_base(tmp_path)
        plan = faults.FaultPlan.parse("kernel.dispatch:raise:1.0:2", seed=7)
        before = _counter_total("dispatch_retries_total")
        with faults.active_plan(plan):
            _, st = _run_one(_service(tmp_path / "chaos"), graph)
        assert st.status is RequestStatus.DONE
        np.testing.assert_allclose(st.result.estimate, base, rtol=F32_RTOL)
        assert plan.stats()["kernel.dispatch:raise"]["fired"] == 2
        assert _counter_total("dispatch_retries_total") > before

    def test_exhausted_budget_fails_with_structured_error(self, tmp_path,
                                                          graph):
        plan = faults.FaultPlan.parse("kernel.dispatch:raise:1.0", seed=7)
        with faults.active_plan(plan):
            svc = _service(tmp_path / "x", retry_policy=RetryPolicy(
                max_attempts=2, base_delay_s=0.01))
            _, st = _run_one(svc, graph)
        assert st.status is RequestStatus.FAILED
        assert st.error_class == "InjectedFault"
        assert "kernel.dispatch" in st.error

    @pytest.mark.parametrize("fails,level,method,fused", [
        (2, "unfused", "bsr", False), (4, "xla", "gather", False)])
    def test_ladder_steps_rebuild_the_engine(self, tmp_path, graph, fails,
                                             level, method, fused):
        """Each step rebuilds the group's engine at the new rung: level 1
        unfused, level 2 on the gather SpMM (the reference's level 2 is its
        segment SpMM); the estimate is the clean one, and the reference's
        ladder lands on the same rung."""
        base = _ref_base(tmp_path, "u5")
        spec = f"kernel.dispatch:raise:1.0:{fails}"
        with faults.active_plan(faults.FaultPlan.parse(spec, seed=7)):
            svc = _service(tmp_path / "lad", degrade_after=2,
                           retry_policy=RetryPolicy(max_attempts=fails + 1,
                                                    base_delay_s=0.001))
            _, st = _run_one(svc, graph, "u5")
        assert st.status is RequestStatus.DONE
        np.testing.assert_allclose(st.result.estimate, base, rtol=F32_RTOL)
        (snap,) = svc.resilience_state()["degraded_ladders"].values()
        assert snap["level_name"] == level
        (grp,) = svc._groups.values()
        assert grp.engine.fuse_spmm_ema is fused
        assert grp.engine.spmm_method == method
        assert grp.engine.device == torch.device("cpu")
        # the reference's ladder, under the same plan, on the same rung
        _, rg = _graphs(48, 5.0, seed=0)
        with ref_faults.active_plan(ref_faults.FaultPlan.parse(spec,
                                                               seed=7)):
            ref = RefService(ledger_root=str(tmp_path / "refl"),
                             round_size=4, default_max_iters=8,
                             degrade_after=2, retry_policy=RefRetryPolicy(
                                 max_attempts=fails + 1, base_delay_s=0.001))
            ref.add_graph("g", rg)
            ref.submit(RefRequest("g", "u5", max_iters=8))
            ref.run()
        (rsnap,) = ref.resilience_state()["degraded_ladders"].values()
        assert rsnap["level_name"] == level

    def test_breaker_quarantines_poison_group(self, tmp_path, graph):
        plan = faults.FaultPlan.parse("kernel.dispatch:raise:1.0", seed=7)
        svc = _service(tmp_path / "br",
                       retry_policy=RetryPolicy(max_attempts=1),
                       breaker_threshold=2, breaker_cooldown_s=300.0)
        svc.add_graph("g", graph)
        with faults.active_plan(plan):
            statuses = []
            for _ in range(3):
                rid = svc.submit(CountRequest("g", "path3", max_iters=8))
                svc.run()
                statuses.append(svc._requests[rid].error_class)
        assert statuses == ["InjectedFault", "InjectedFault", "CircuitOpen"]
        assert svc.resilience_state()["breakers"]["counts"]["open"] == 1
        (br,) = svc._breakers._breakers.values()
        br._opened_at -= 600.0                 # cooldown elapsed
        rid = svc.submit(CountRequest("g", "path3", max_iters=8))
        svc.run()
        assert svc._requests[rid].status is RequestStatus.DONE
        assert svc.resilience_state()["breakers"]["counts"]["closed"] == 1

    def test_hung_dispatch_caught_by_watchdog(self, tmp_path, graph):
        """The watchdog abandons a hung attempt and the retry gives the
        clean estimate. No wall-clock bound is asserted: that the
        ``DispatchTimeout`` fired is read from the retry counter."""
        base = _ref_base(tmp_path)
        plan = faults.FaultPlan(
            [faults.FaultSpec("dispatch.hang", mode="hang", hang_s=6.0,
                              times=1)], seed=1)
        before = _counter_total("dispatch_retries_total", reason="timeout")
        with faults.active_plan(plan):
            # a watchdog far above a clean dispatch (milliseconds here),
            # so only the hung attempt times out, however loaded the host
            svc = _service(tmp_path / "hang", retry_policy=RetryPolicy(
                max_attempts=3, base_delay_s=0.01, timeout_s=3.0))
            _, st = _run_one(svc, graph)
        assert st.status is RequestStatus.DONE
        np.testing.assert_allclose(st.result.estimate, base, rtol=F32_RTOL)
        assert plan.stats()["dispatch.hang:hang"]["fired"] == 1
        assert _counter_total("dispatch_retries_total",
                              reason="timeout") - before >= 1

    def test_watchdog_raises_dispatch_timeout(self):
        import threading
        release = threading.Event()
        with pytest.raises(DispatchTimeout):
            run_with_timeout(lambda c: release.wait(30.0), 0.05)
        release.set()

    def test_unaffected_group_untouched_by_scoped_chaos(self, tmp_path,
                                                        graph):
        from repro_torch.core.templates import TemplateSpec
        base_s = _ref_base(tmp_path, "star4")
        svc = _service(tmp_path / "scoped",
                       retry_policy=RetryPolicy(max_attempts=1))
        svc.add_graph("g", graph)
        h3 = TemplateSpec.of("path3").canonical_hash[:8]
        plan = faults.FaultPlan([faults.FaultSpec(
            "kernel.dispatch", match=h3)], seed=7)
        with faults.active_plan(plan):
            r1 = svc.submit(CountRequest("g", "path3", max_iters=8))
            r2 = svc.submit(CountRequest("g", "star4", max_iters=8))
            svc.run()
        assert svc._requests[r1].status is RequestStatus.FAILED
        assert svc._requests[r2].status is RequestStatus.DONE
        np.testing.assert_allclose(svc._requests[r2].result.estimate,
                                   base_s, rtol=F32_RTOL)


def test_reference_engine_and_template_agree_on_the_chaos_graph(graph):
    """The chaos tests' reference base runs the same graph and stream."""
    _, rg = _graphs(48, 5.0, seed=0)
    assert rg.fingerprint == graph.fingerprint
    ref = ref_build_engine(rg, ref_get_template("path3"), "pgbsc")
    eng = build_engine(graph, "path3", "pgbsc", device="cpu")
    want = ref.count_iterations_batch(range(4), seed=0)
    got = eng.count_iterations_batch(range(4), seed=0)
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], rtol=F32_RTOL)
    assert os.path.sep not in eng.template.canonical_hash
