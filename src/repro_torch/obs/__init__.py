"""Observability layer: tracing spans + metrics registry + snapshot schema.

Copies of the JAX package's ``obs/`` with torch device hooks, under the
same names: :mod:`repro_torch.obs.tracing` and
:mod:`repro_torch.obs.metrics` for the two halves,
:mod:`repro_torch.obs.validate` for the snapshot schema contract.
"""

from repro_torch.obs import metrics, tracing
from repro_torch.obs.metrics import (MetricsRegistry, counter, gauge,
                                     get_registry, histogram, set_registry,
                                     snapshot, to_prometheus)
from repro_torch.obs.tracing import (Tracer, arm_profiler, configure,
                                     get_tracer, profiled_dispatch,
                                     set_tracer, span, sync_ready)
from repro_torch.obs.validate import validate_snapshot

__all__ = [
    "metrics", "tracing",
    "MetricsRegistry", "counter", "gauge", "histogram", "get_registry",
    "set_registry", "snapshot", "to_prometheus",
    "Tracer", "span", "configure", "get_tracer", "set_tracer", "sync_ready",
    "arm_profiler", "profiled_dispatch",
    "validate_snapshot",
]
