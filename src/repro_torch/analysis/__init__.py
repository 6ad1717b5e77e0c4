"""repro_torch.analysis: run-time invariant checks of the solver plans.

Port of ``repro.analysis`` (the plan audit; the AST linter is not
ported).  :mod:`repro_torch.analysis.plan_audit` runs a plan's impl
under a dispatch mode and checks what ran: all-reduces per grouped axis
against the (r, sep) budget, no f64 compute in an f32-compute plan, no
host syncs on a static path.  Surfaced as ``SvdPlan.audit()`` /
``TopKPlan.audit()`` and the ``audit_plans`` option of
:class:`repro_torch.serve.SvdService`.
"""

from repro_torch.analysis.plan_audit import (
    AuditError,
    AuditReport,
    audit_all_plans,
    audit_callable,
    audit_plan,
    audit_stats,
    executed_dynamic_psums,
    expected_grouped_psums,
    reset_audit_stats,
    wide_ok,
)

__all__ = [
    "AuditError",
    "AuditReport",
    "audit_all_plans",
    "audit_callable",
    "audit_plan",
    "audit_stats",
    "executed_dynamic_psums",
    "expected_grouped_psums",
    "reset_audit_stats",
    "wide_ok",
]
