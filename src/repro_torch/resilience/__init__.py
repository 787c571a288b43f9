"""Failure containment of the port, copies of the JAX package's modules of
the same names:

* :mod:`repro_torch.resilience.faults` — the seed-deterministic
  fault-injection harness (named injection points, ``serve --inject``);
* :mod:`repro_torch.resilience.retry` — retry budgets, jittered
  exponential backoff, and the dispatch watchdog (hung-dispatch
  detection);
* :mod:`repro_torch.resilience.degradation` — the per-engine degradation
  ladder (fused → unfused → gather SpMM, bf16 → f32) and per-group
  circuit breakers;
* :mod:`repro_torch.resilience.recovery` — checksummed, versioned JSON
  state with quarantine-on-corruption loads (ledgers, caches).

Design rule: containment code never special-cases injected faults — an
:class:`~repro_torch.resilience.faults.InjectedFault` is an ordinary
exception, so surviving the chaos suite means surviving the real thing.
"""

from repro_torch.resilience.degradation import (LADDER_LEVELS, BreakerBoard,
                                                CircuitBreaker, CircuitOpen,
                                                DegradationState)
from repro_torch.resilience.faults import (FaultPlan, FaultSpec,
                                           InjectedFault, active_plan,
                                           clear_plan, current_plan,
                                           install_plan)
from repro_torch.resilience.recovery import (load_checked, quarantine,
                                             write_checked)
from repro_torch.resilience.retry import (DispatchTimeout, RetryPolicy,
                                          run_with_timeout)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault",
    "install_plan", "clear_plan", "current_plan", "active_plan",
    "RetryPolicy", "DispatchTimeout", "run_with_timeout",
    "DegradationState", "CircuitBreaker", "CircuitOpen", "BreakerBoard",
    "LADDER_LEVELS",
    "load_checked", "write_checked", "quarantine",
]
