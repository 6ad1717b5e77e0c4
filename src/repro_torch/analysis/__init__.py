"""repro_torch.analysis: invariant checks of the port, static and at run
time.

Two layers, as in the reference (``repro.analysis``):

* :mod:`repro_torch.analysis.lint` — a stdlib-only AST linter
  (``python -m repro_torch.analysis src/repro_torch``) encoding the
  repo's hand-learned invariants as seven precision-first rules in torch
  form (``analysis/README.md`` holds the catalog, each rule named with
  the historical bug it guards against and the reference rule it stands
  for).
* :mod:`repro_torch.analysis.plan_audit` runs a plan's impl under a
  dispatch mode and checks what ran: all-reduces per grouped axis
  against the (r, sep) budget, no f64 compute in an f32-compute plan, no
  host syncs on a static path.  Surfaced as ``SvdPlan.audit()`` /
  ``TopKPlan.audit()`` and the ``audit_plans`` option of
  :class:`repro_torch.serve.SvdService`.

The lint layer imports no ``torch`` (the CLI runs on a bare Python): the
plan audit's names load on first use.
"""

from repro_torch.analysis.lint.engine import (
    FileContext,
    Finding,
    LintResult,
    Rule,
    all_rules,
    load_baseline,
    register_rule,
    resolve_rules,
    run_lint,
    write_baseline,
)

_AUDIT = (
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
)


def __getattr__(name):
    if name in _AUDIT:
        from repro_torch.analysis import plan_audit as _plan_audit

        return getattr(_plan_audit, name)
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")


__all__ = [
    "FileContext",
    "Finding",
    "LintResult",
    "Rule",
    "all_rules",
    "load_baseline",
    "register_rule",
    "resolve_rules",
    "run_lint",
    "write_baseline",
    *_AUDIT,
]
