"""The port's observability hooks: the engine's spans and counters, and the
torch device hooks of the tracer (``sync_ready``, the one-shot
``torch.profiler`` trace) that replace the JAX package's."""

import json

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
