"""The port's observability hooks: the engine's spans and counters, the
torch device hooks of the tracer (``sync_ready``, the one-shot
``torch.profiler`` trace) that replace the JAX package's, and the snapshot
validator, which accepts both packages' snapshots."""

import json

import pytest
import torch

from repro_torch.core.engines import CountingEngine
from repro_torch.graph.generators import grid_2d
from repro_torch.obs import metrics, tracing


def test_engine_walk_emits_dispatch_and_node_spans():
    old = tracing.get_tracer()
    tracer = tracing.set_tracer(tracing.Tracer(enabled=True, sync=True))
    try:
        eng = CountingEngine(grid_2d(8, 8), "u5", plan="optimized",
                             device="cpu")
        eng.count_colorful_batch(torch.zeros((2, 64), dtype=torch.int32))
    finally:
        tracing.set_tracer(old)
    agg = tracer.breakdown()
    assert agg["engine.dispatch"]["count"] == 1
    # one span per internal node of u5's optimized plan
    assert agg["plan.node"]["count"] == 4
    dispatch = [r for r in tracer.roots if r.name == "engine.dispatch"][0]
    modes = sorted(c.attrs["mode"] for c in dispatch.children)
    assert modes == ["cached", "cached", "cached", "fused"]


def test_fusion_admissions_are_counted():
    before = metrics.counter("fusion_admissions_total",
                             outcome="admitted").value
    CountingEngine(grid_2d(8, 8), "u12", plan="optimized", device="cpu")
    after = metrics.counter("fusion_admissions_total",
                            outcome="admitted").value
    assert after - before == 5


def test_profiled_dispatch_writes_one_chrome_trace(tmp_path):
    tracing.arm_profiler(str(tmp_path))
    with tracing.profiled_dispatch():
        torch.ones(64).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    # one-shot: the next dispatch runs unprofiled
    (tmp_path / "trace.json").unlink()
    with tracing.profiled_dispatch():
        torch.ones(64).sum()
    assert not (tmp_path / "trace.json").exists()


def test_sync_ready_ignores_cpu_tensors():
    old = tracing.get_tracer()
    tracing.set_tracer(tracing.Tracer(enabled=True, sync=True))
    try:
        tracing.sync_ready(torch.ones(3))     # nothing to wait for
    finally:
        tracing.set_tracer(old)


def _service_snapshot(pkg: str, tmp_path) -> dict:
    """A metrics snapshot of one small service run in ``pkg``."""
    if pkg == "port":
        from repro_torch.service import CountingService, CountRequest
        svc = CountingService(ledger_root=str(tmp_path / "p"),
                              device="cpu", round_size=4)
        svc.add_graph("g", grid_2d(6, 6))
        snap = metrics.snapshot
    else:
        from repro.graph import generators as ref_gen
        from repro.obs import metrics as ref_metrics
        from repro.service import CountingService, CountRequest
        svc = CountingService(ledger_root=str(tmp_path / "r"), round_size=4)
        svc.add_graph("g", ref_gen.grid_2d(6, 6))
        snap = ref_metrics.snapshot
    svc.submit(CountRequest("g", "u5", max_iters=4))
    svc.run()
    return json.loads(json.dumps(snap()))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_packages_snapshot_validates_in_both(writer, tmp_path):
    pytest.importorskip("jax")
    from repro.obs.validate import validate_snapshot as ref_validate
    from repro_torch.obs.validate import validate_snapshot
    snap = _service_snapshot(writer, tmp_path)
    assert validate_snapshot(snap) is snap
    ref_validate(snap)
    assert any(k.startswith("service_rounds_total")
               for k in snap["counters"])


def test_validate_rejects_corruption():
    from repro_torch.obs.validate import validate_snapshot
    good = json.loads(json.dumps(metrics.MetricsRegistry().snapshot()))
    validate_snapshot(good)
    for mutate in (lambda d: d.update(schema=99),
                   lambda d: d.update(counters=[]),
                   lambda d: d["gauges"].update(bad=float("nan"))):
        bad = json.loads(json.dumps(good))
        mutate(bad)
        with pytest.raises(ValueError):
            validate_snapshot(bad)


def test_validate_cli_requires_nonzero_counters(tmp_path, capsys):
    from repro_torch.obs.validate import main
    reg = metrics.MetricsRegistry()
    reg.counter("service_rounds_total").inc()
    reg.histogram("service_request_total_seconds", qos="batch").observe(0.5)
    p = tmp_path / "snap.json"
    p.write_text(json.dumps(reg.snapshot()))
    assert main([str(p), "--require-nonzero", "service_rounds",
                 "--require-hist", "qos="]) == 0
    assert main([str(p), "--require-nonzero", "no_such_counter"]) == 1
