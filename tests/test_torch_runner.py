"""The port's fault-tolerant estimator runner, its fault-injection harness
and its checksummed state files, against the JAX package's.

The runner's invariant is the reference's: a run cut short and resumed by
a new runner gives the per-iteration sums of an uninterrupted run bit for
bit, on every engine. The ledger's bytes are the reference's, so a ledger
written by either package loads as ``"ok"`` in the other, and a run
started by one package resumes in the other with the same sums.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import build_engine as ref_build_engine  # noqa: E402
from repro.core import runner as ref_runner  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.resilience import faults as ref_faults  # noqa: E402
from repro.resilience import recovery as ref_recovery  # noqa: E402
from repro_torch.core import build_engine  # noqa: E402
from repro_torch.core import count_subgraphs_exact, get_template  # noqa: E402
from repro_torch.core.runner import EstimatorRunner  # noqa: E402
from repro_torch.core.runner import RunnerResult, engine_counter  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.obs import metrics as _metrics  # noqa: E402
from repro_torch.obs import tracing as _tracing  # noqa: E402
from repro_torch.resilience import faults, recovery  # noqa: E402


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


def _graph():
    return generators.erdos_renyi(30, 4.0, seed=0)


def _runner(tmp, engine="pgbsc", n_iters=10, sub="a", tname="u3", seed=9,
            every=3, batch_size=None):
    t = get_template(tname)
    eng = build_engine(_graph(), t, engine, device="cpu")
    return EstimatorRunner(
        engine_counter(eng, seed=seed, batch_size=batch_size), k=t.k,
        automorphisms=t.automorphisms, n_iterations=n_iters,
        ledger_dir=os.path.join(tmp, sub), checkpoint_every=every, seed=seed)


def _counter_value(name, **labels):
    return _metrics.counter(name, **labels).value


# ------------------------------------------------------------- the runner
@pytest.mark.parametrize("engine", ["fascia", "pfascia", "pgbsc"])
def test_resume_equals_straight(tmp_path, engine):
    r1 = _runner(str(tmp_path), engine, tname="u5", sub="x")
    partial = r1.run(max_iterations_this_call=4)
    assert len(partial.completed) == 4
    resumed = _runner(str(tmp_path), engine, tname="u5", sub="x").run()
    straight = _runner(str(tmp_path), engine, tname="u5", sub="y").run()
    assert isinstance(resumed, RunnerResult)
    assert resumed.per_iteration == straight.per_iteration
    assert resumed.count == straight.count
    assert len(resumed.completed) == 10
    assert resumed.restarts >= 1 and straight.restarts == 0


def test_resume_equals_straight_at_any_batch(tmp_path):
    """Checkpoints of 3 against batches of 1 and 4: per-iteration sums do
    not depend on the batch an iteration ran in."""
    runs = [_runner(str(tmp_path), "pgbsc", tname="u5", sub=f"b{b}",
                    every=every, batch_size=b).run()
            for b, every in ((None, 3), (1, 8), (4, 8))]
    assert all(r.per_iteration == runs[0].per_iteration for r in runs[1:])


@pytest.mark.parametrize("engine", ["pfascia", "pgbsc"])
def test_totals_are_exact_float64_sums(engine):
    """Each coloring's total is its root table's exact sum (float64, then
    the accumulator dtype): no summation order, so no batch, changes it.
    On the card an f32 sum over a (B, 1, n) table past 2^24 changes with
    B (chip_smoke.py's runner phase)."""
    eng = build_engine(_graph(), "u3", engine, device="cpu")
    big = float(1 << 24)
    root = torch.tensor([[big, 1.0, 1.0, 1.0, 1.0], [1.0, 1.0, big, 3.0,
                                                     1.0]])
    root = root[:, None, :] if engine == "pgbsc" else root[:, :, None]
    got = eng._totals(root)
    assert got.dtype == torch.float32
    assert got.tolist() == [big + 4, big + 6]
    assert eng._totals(root[1:]).tolist() == [big + 6]


def test_ledger_mismatch_restarts_clean(tmp_path):
    _runner(str(tmp_path), n_iters=5, sub="z").run()
    # a different iteration budget -> a fresh ledger
    res = _runner(str(tmp_path), n_iters=8, sub="z").run()
    assert len(res.completed) == 8 and res.restarts == 0


@pytest.mark.parametrize("engine", ["fascia", "pgbsc"])
def test_estimate_near_exact(tmp_path, engine):
    g = _graph()
    t = get_template("u3")
    eng = build_engine(g, t, engine, device="cpu")
    r = EstimatorRunner(engine_counter(eng, seed=1), k=t.k,
                        automorphisms=t.automorphisms, n_iterations=150,
                        ledger_dir=str(tmp_path / "e"),
                        checkpoint_every=50, seed=1)
    res = r.run()
    assert res.count == pytest.approx(count_subgraphs_exact(g, t), rel=0.25)


def test_adaptive_rounds_serve_ledgered_ids(tmp_path):
    t = get_template("u3")
    eng = build_engine(_graph(), t, device="cpu")
    calls = []

    def counter(its):
        calls.append(list(its))
        return engine_counter(eng, seed=2)(its)

    mk = lambda: EstimatorRunner(  # noqa: E731
        counter, k=t.k, automorphisms=t.automorphisms, n_iterations=None,
        ledger_dir=str(tmp_path / "ad"), checkpoint_every=4, seed=2)
    first = mk().run_iterations(range(6))
    assert calls == [[0, 1, 2, 3], [4, 5]]
    calls.clear()
    again = mk().run_iterations(range(8))
    assert calls == [[6, 7]]
    assert {i: again[i] for i in range(6)} == first
    with pytest.raises(ValueError, match="n_iterations"):
        mk().run()


def test_checkpoints_are_counted_and_traced(tmp_path):
    before = _counter_value("runner_checkpoints_total")
    its = _counter_value("runner_iterations_total")
    old = _tracing.get_tracer()
    tracer = _tracing.set_tracer(_tracing.Tracer(enabled=True))
    try:
        _runner(str(tmp_path), n_iters=7, every=3).run()
    finally:
        _tracing.set_tracer(old)
    assert _counter_value("runner_checkpoints_total") - before == 3
    assert _counter_value("runner_iterations_total") - its == 7
    assert tracer.breakdown()["runner.checkpoint"]["count"] == 3


# ---------------------------------------------------------------- chaos
def test_injected_dispatch_fault_keeps_the_first_checkpoint(tmp_path):
    straight = _runner(str(tmp_path), tname="u5", sub="s").run()
    plan = faults.FaultPlan([faults.FaultSpec("kernel.dispatch", after=1,
                                              times=1)])
    with faults.active_plan(plan):
        with pytest.raises(faults.InjectedFault):
            _runner(str(tmp_path), tname="u5", sub="c").run()
    r = _runner(str(tmp_path), tname="u5", sub="c")
    assert sorted(r.completed_iterations()) == [0, 1, 2]
    resumed = r.run()
    assert resumed.per_iteration == straight.per_iteration
    assert resumed.restarts == 1


def test_torn_ledger_restarts_cold(tmp_path):
    """A ledger torn mid-checkpoint costs recomputation, never a crash —
    and the recomputed estimate is bitwise identical."""
    base = _runner(str(tmp_path), sub="clean").run()
    root = tmp_path / "torn"
    plan = faults.FaultPlan(
        [faults.FaultSpec("ledger.write", mode="corrupt", after=1, times=1)],
        seed=3)
    with faults.active_plan(plan):
        torn = _runner(str(root), sub="l").run()
    assert torn.count == base.count
    before = _counter_value("runner_ledger_corruptions_total", reason="json")
    # later checkpoints rewrote the torn one; tear the file as a kill -9
    # mid-write would, and the next runner quarantines it and starts cold
    path = root / "l" / "ledger.json"
    path.write_bytes(path.read_bytes()[:20])
    again = _runner(str(root), sub="l").run()
    assert again.count == base.count and again.restarts == 0
    assert (root / "l" / "ledger.json.corrupt").exists()
    assert _counter_value("runner_ledger_corruptions_total",
                          reason="json") - before == 1


def test_corrupt_last_checkpoint_quarantined_on_next_load(tmp_path):
    plan = faults.FaultPlan(
        [faults.FaultSpec("ledger.write", mode="corrupt", after=3,
                          times=1)])
    with faults.active_plan(plan):
        first = _runner(str(tmp_path), sub="q").run()
    r = _runner(str(tmp_path), sub="q")
    assert r.completed_iterations() == {}
    assert (tmp_path / "q" / "ledger.json.corrupt").exists()
    assert r.run().per_iteration == first.per_iteration


# ----------------------------------------------------------- the harness
def test_same_seed_same_schedule():
    fires = []
    for _ in range(2):
        plan = faults.FaultPlan.parse("kernel.dispatch:raise:0.5", seed=42)
        pattern = []
        with faults.active_plan(plan):
            for _ in range(40):
                try:
                    faults.inject("kernel.dispatch")
                    pattern.append(0)
                except faults.InjectedFault:
                    pattern.append(1)
        fires.append(pattern)
    assert fires[0] == fires[1]
    assert 0 < sum(fires[0]) < 40


def test_fault_schedule_equals_reference():
    """Same plan, same hits -> the same firings and truncations in both
    packages (their streams and offsets are one design)."""
    pattern = {}
    for name, mod in (("port", faults), ("ref", ref_faults)):
        plan = mod.FaultPlan.parse("kernel.dispatch:raise:0.3", seed=7)
        seq = []
        with mod.active_plan(plan):
            for _ in range(30):
                try:
                    mod.inject("kernel.dispatch")
                    seq.append(0)
                except mod.InjectedFault:
                    seq.append(1)
        cplan = mod.FaultPlan([mod.FaultSpec("ledger.write", mode="corrupt")],
                              seed=5)
        with mod.active_plan(cplan):
            cut = mod.corrupt_bytes("ledger.write", b"y" * 300)
        pattern[name] = (seq, cut)
    assert pattern["port"] == pattern["ref"]


def test_times_budget_and_after():
    plan = faults.FaultPlan(
        [faults.FaultSpec("kernel.dispatch", times=2, after=1)])
    raised = []
    with faults.active_plan(plan):
        for _ in range(6):
            try:
                faults.inject("kernel.dispatch")
                raised.append(0)
            except faults.InjectedFault:
                raised.append(1)
    assert raised == [0, 1, 1, 0, 0, 0]


def test_match_scopes_to_one_context():
    plan = faults.FaultPlan(
        [faults.FaultSpec("kernel.dispatch", match="poison")])
    with faults.active_plan(plan):
        faults.inject("kernel.dispatch", context="healthy-group")
        with pytest.raises(faults.InjectedFault):
            faults.inject("kernel.dispatch", context="poison-group")


def test_no_plan_is_noop_and_fault_is_runtime_error():
    faults.clear_plan()
    faults.inject("kernel.dispatch")
    assert issubclass(faults.InjectedFault, RuntimeError)


def test_parse_rejects_unknown_point_and_mode_and_reads_json(tmp_path):
    with pytest.raises(ValueError):
        faults.FaultPlan.parse("not.a.point:raise")
    with pytest.raises(ValueError):
        faults.FaultPlan.parse("kernel.dispatch:explode")
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"seed": 9, "faults": [
        {"point": "ledger.write", "mode": "corrupt", "rate": 1.0}]}))
    plan = faults.FaultPlan.parse(str(p))
    assert plan.seed == 9 and plan.specs[0].mode == "corrupt"


def test_engine_counter_labels_its_dispatch_point(tmp_path):
    eng = build_engine(_graph(), "u3", "pfascia", device="cpu")
    plan = faults.FaultPlan([faults.FaultSpec("kernel.dispatch",
                                              match="pfascia")])
    with faults.active_plan(plan):
        with pytest.raises(faults.InjectedFault, match="pfascia"):
            engine_counter(eng)([0])
        assert engine_counter(eng, label="other")([0])


# --------------------------------------------------------------- recovery
def test_roundtrip(tmp_path):
    p = str(tmp_path / "state.json")
    recovery.write_checked(p, {"a": 1})
    assert recovery.load_checked(p, kind="t") == ({"a": 1}, "ok")


def test_missing_is_clean_cold_start(tmp_path):
    payload, status = recovery.load_checked(str(tmp_path / "nope.json"),
                                            kind="t")
    assert payload is None and status == "missing"


@pytest.mark.parametrize("content,reason", [
    (b"{\"envelope\": 1, \"crc\": 0, \"payl", "json"),   # torn write
    (b"\x00\x01garbage", "json"),
    (b"[1, 2, 3]", "schema"),
    (b"{\"envelope\": 1, \"crc\": 123, \"payload\": {}}", "crc"),
])
def test_bad_state_quarantined_not_raised(tmp_path, content, reason):
    p = tmp_path / "state.json"
    p.write_bytes(content)
    payload, status = recovery.load_checked(str(p), kind="t")
    assert payload is None and status == reason
    assert not p.exists()
    assert p.with_suffix(".json.corrupt").exists()


def test_legacy_pre_envelope_dict_loads(tmp_path):
    p = tmp_path / "old.json"
    p.write_text(json.dumps({"completed": {"0": 1.0}, "seed": 0}))
    payload, status = recovery.load_checked(str(p), kind="t")
    assert status == "ok" and payload["completed"] == {"0": 1.0}


def test_injected_corrupt_write_quarantines_on_next_load(tmp_path):
    p = str(tmp_path / "state.json")
    plan = faults.FaultPlan(
        [faults.FaultSpec("ledger.write", mode="corrupt", times=1)])
    with faults.active_plan(plan):
        recovery.write_checked(p, {"a": 1}, fault_point="ledger.write")
    payload, status = recovery.load_checked(p, kind="t")
    assert payload is None and status == "json"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_state_written_by_either_package_loads_in_the_other(tmp_path,
                                                            writer):
    payload = {"seed": 3, "n_iterations": 4, "restarts": 0,
               "completed": {"0": 12.0, "1": 16777217.0, "2": 0.1}}
    w, r = (recovery, ref_recovery) if writer == "port" else (ref_recovery,
                                                               recovery)
    p = str(tmp_path / "ledger.json")
    w.write_checked(p, payload)
    assert r.load_checked(p, kind="ledger") == (payload, "ok")
    q = str(tmp_path / "other.json")
    r.write_checked(q, payload)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()
    assert recovery.payload_crc(payload) == ref_recovery.payload_crc(payload)


@pytest.mark.parametrize("starter", ["port", "ref"])
def test_run_resumes_across_packages(tmp_path, starter):
    """Half a run in one package, the rest in the other: the per-iteration
    sums of a straight run in the port (integer counts: exact on both)."""
    t = get_template("u5")
    kw = dict(k=t.k, automorphisms=t.automorphisms, n_iterations=8,
              ledger_dir=str(tmp_path / "x"), checkpoint_every=3, seed=4)
    port_eng = build_engine(_graph(), t, "pfascia", device="cpu")
    ref_eng = ref_build_engine(ref_gen.erdos_renyi(30, 4.0, seed=0), "u5",
                               "pgbsc")
    port = lambda: EstimatorRunner(  # noqa: E731
        engine_counter(port_eng, seed=4), **kw)
    ref = lambda: ref_runner.EstimatorRunner(  # noqa: E731
        ref_runner.engine_counter(ref_eng, seed=4), **kw)
    first, second = (port, ref) if starter == "port" else (ref, port)
    first().run(max_iterations_this_call=3)
    resumed = second().run()
    straight = EstimatorRunner(
        engine_counter(port_eng, seed=4),
        **{**kw, "ledger_dir": str(tmp_path / "straight")}).run()
    assert resumed.restarts == 1
    assert resumed.per_iteration == straight.per_iteration
    assert resumed.count == straight.count


def test_ledger_holds_python_floats(tmp_path):
    r = _runner(str(tmp_path), n_iters=3)
    res = r.run()
    assert all(type(v) is float for v in res.per_iteration.values())
    led, status = recovery.load_checked(r.ledger_path, kind="ledger")
    assert status == "ok" and set(led["completed"]) == {"0", "1", "2"}
    assert all(type(v) is float for v in led["completed"].values())
    assert np.isfinite(res.count)
