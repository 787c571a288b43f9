"""Failure containment of the port: the fault-injection harness
(:mod:`repro_torch.resilience.faults`) and checksummed, quarantining state
files (:mod:`repro_torch.resilience.recovery`), copies of the JAX
package's modules of the same names. The degradation ladder and the retry
policy come with the service stack (``ROADMAP.md``).

Design rule: containment code never special-cases injected faults — an
:class:`~repro_torch.resilience.faults.InjectedFault` is an ordinary
exception, so surviving the chaos suite means surviving the real thing.
"""

from repro_torch.resilience.faults import (FaultPlan, FaultSpec,
                                           InjectedFault, active_plan,
                                           clear_plan, current_plan,
                                           install_plan)
from repro_torch.resilience.recovery import (load_checked, quarantine,
                                             write_checked)

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault",
    "install_plan", "clear_plan", "current_plan", "active_plan",
    "load_checked", "write_checked", "quarantine",
]
