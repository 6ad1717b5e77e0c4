"""Runtime breakdown detection and recovery.

Port of ``repro.resilience``.  Three layers, each usable alone:

* :mod:`repro_torch.resilience.health` — :class:`SolveHealth` (one extra
  Gram product per solve, on the device) and the host-side
  :class:`HealthVerdict` that judges it.
* :mod:`repro_torch.resilience.escalate` — the deterministic escalation
  ladder: re-plan one capability notch more conservative until a rung's
  verdict passes, else raise :class:`SolveFailure` with the full trail.
* :mod:`repro_torch.resilience.faultinject` — deterministic fault
  injection (NaN / indefinite-Gram ops bundles, serving fault plans) so
  the recovery paths above are *tested* paths.
"""

from repro_torch.resilience.errors import (Backpressure, CircuitOpen,
                                           DeadlineExceeded, FutureTimeout,
                                           ResilienceError, SolveFailure)
from repro_torch.resilience.escalate import (RungAttempt, escalation_ladder,
                                             solve_with_escalation)
from repro_torch.resilience.faultinject import ServiceFaults, faulty_ops
from repro_torch.resilience.health import (HealthVerdict, SolveHealth,
                                           default_orth_tol, judge,
                                           judge_plan, solve_health)

__all__ = [
    "Backpressure",
    "CircuitOpen",
    "DeadlineExceeded",
    "FutureTimeout",
    "HealthVerdict",
    "ResilienceError",
    "RungAttempt",
    "ServiceFaults",
    "SolveFailure",
    "SolveHealth",
    "default_orth_tol",
    "escalation_ladder",
    "faulty_ops",
    "judge",
    "judge_plan",
    "solve_health",
    "solve_with_escalation",
]
