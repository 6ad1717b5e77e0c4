"""Deterministic escalation: from a failed solve to the next-safer plan.

Port of ``repro/resilience/escalate.py``.  When a solve's runtime verdict
(:mod:`repro_torch.resilience.health`) comes back unhealthy, there is a
well-ordered set of things to try next, and every one of them is already
a planner capability — the ladder never invents a solver, it re-plans
through the plan cache with a config one notch more conservative:

1. **as planned** — the rung-0 config itself (its verdict is what
   starts the climb).
2. **kernel fallback** — the registry spec's ``fallback`` method
   (``zolo_cuda -> zolo_static``, ``zolo_cuda_dynamic -> zolo``): the
   same math on plain torch ops, out of the kernels' f32-accumulation
   envelope.
3. **first-iteration factorization** — up the stability order
   ``chol -> cholqr2 -> householder`` (paper §3.1: the structured
   Householder QR is the paper-faithful stable term).
4. **static -> dynamic** — drop the precomputed schedule for a
   run-time-conditioning backend (``l0_policy="runtime"``): whatever
   mis-estimate of l0/kappa broke the schedule, the run-time bound
   re-measures it.
5. **f32 -> f64 compute** — the last resort for precision-limited
   breakdowns.

Rungs are derived from registry capability flags (``fallback``,
``dynamic``, ``is_oracle``) and the config — never from method names —
so a new backend slots into the ladder by declaring its flags.  Every
rung is planned on the input's device (and mesh).  A rung whose config
cannot plan there (e.g. an f64 compute on a kernel backend, or
``householder`` on a sep > 1 mesh) is recorded in the trail as
``plan-error`` and skipped, not silently dropped.  If no rung passes,
:class:`~repro_torch.resilience.errors.SolveFailure` carries the full
:class:`RungAttempt` trail out.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core import registry as _registry
from repro_torch.core.zolo import ITER_MODES
from repro_torch.resilience import health as _health
from repro_torch.resilience.errors import SolveFailure
from repro_torch.solver.config import COMPUTE_DTYPES, SvdConfig


@dataclasses.dataclass(frozen=True)
class RungAttempt:
    """One rung of the ladder, as actually tried."""

    rung: int
    reason: str
    config: SvdConfig
    outcome: str  # "passed" | "failed" | "plan-error"
    error: Optional[str] = None
    verdict: Optional[_health.HealthVerdict] = None


# stability order of the first-iteration factorization (ITER_MODES is
# the engine's unordered choice set; this is the escalation order)
_QR_LADDER = ("chol", "cholqr2", "householder")
# what the engine actually runs when qr_mode is unset (the planner's
# static default / the dynamic drivers' mid-regime pick)
_QR_DEFAULT = "cholqr2"


def escalation_ladder(plan) -> List[Tuple[SvdConfig, str]]:
    """Ordered ``(config, reason)`` rungs for ``plan``, rung 0 first.

    Deterministic — same plan, same ladder — and derived from the
    rung-0 plan's resolved method spec, so ``method="auto"`` configs
    escalate from what auto actually picked.
    """
    if set(_QR_LADDER) != set(ITER_MODES):
        raise RuntimeError(
            f"escalation ladder order {_QR_LADDER} no longer covers the "
            f"engine's iteration modes {ITER_MODES}; update _QR_LADDER")
    cfg = plan.config
    rungs: List[Tuple[SvdConfig, str]] = [(cfg, "as planned")]
    spec = _registry.get_polar(plan.method)
    cur = cfg

    if spec.fallback is not None:
        # pin the resolved method first so the fallback replaces what
        # actually ran, not an "auto" re-resolution back to the kernel
        cur = cur.replace(method=spec.fallback)
        rungs.append((cur,
                      f"kernel fallback {spec.name} -> {spec.fallback}"))
        spec = _registry.get_polar(spec.fallback)

    qr_now = cur.qr_mode if cur.qr_mode is not None else _QR_DEFAULT
    start = _QR_LADDER.index(qr_now) if qr_now in _QR_LADDER \
        else len(_QR_LADDER) - 1
    for mode in _QR_LADDER[start + 1:]:
        cur = cur.replace(qr_mode=mode)
        rungs.append((cur, f"first-iteration factorization -> {mode}"))

    if not spec.dynamic and not spec.is_oracle:
        # re-measure the conditioning at run time: whatever l0/kappa
        # mis-estimate broke the precomputed schedule does not carry
        # over.  qr_mode resets to the driver's run-time regime switch.
        cur = cur.replace(method="auto", mode="auto", l0=None, kappa=None,
                          l0_policy="runtime", qr_mode=None)
        rungs.append((cur, "static schedule -> runtime conditioning"))

    compute = COMPUTE_DTYPES[cur.compute_dtype] \
        if cur.compute_dtype is not None else plan.dtype
    if compute.itemsize < 8:
        cur = cur.replace(compute_dtype="float64")
        rungs.append((cur, "compute dtype -> float64"))

    deduped: List[Tuple[SvdConfig, str]] = []
    for rung in rungs:
        if not deduped or deduped[-1][0] != rung[0]:
            deduped.append(rung)
    return deduped


def solve_with_escalation(a, config: SvdConfig, *, mesh=None,
                          orth_tol: Optional[float] = None,
                          max_rungs: Optional[int] = None):
    """Verified SVD of one matrix, climbing the ladder until healthy.

    Every rung is planned on ``a``'s device (and on ``mesh``, a
    :func:`repro_torch.dist.zolo_group_mesh` whose every rank calls this
    with the full ``a``) through the plan cache (a retried rung re-uses
    its plan), every attempt is judged by
    :func:`repro_torch.resilience.health.judge_plan`, and the return is
    ``(u, s, vh, trail)`` from the first healthy rung.  Exhausting the
    ladder raises :class:`SolveFailure` carrying the full trail.

    Single-matrix by contract: batched callers do their own per-entry
    triage so one poison matrix cannot drag its batch siblings up the
    ladder with it.
    """
    from repro_torch.solver import planner as _planner

    if a.ndim != 2:
        raise ValueError(
            f"solve_with_escalation takes one (m, n) matrix, got shape "
            f"{tuple(a.shape)}; batched callers triage entries "
            f"individually")
    shape = tuple(a.shape)
    plan0 = _planner.plan(config, shape, a.dtype, device=a.device,
                          mesh=mesh)
    ladder = escalation_ladder(plan0)
    if max_rungs is not None:
        ladder = ladder[:max_rungs]
    trail: List[RungAttempt] = []
    for i, (cfg, reason) in enumerate(ladder):
        try:
            p = _planner.plan(cfg, shape, a.dtype, device=a.device,
                              mesh=mesh)
        except (ValueError, TypeError) as e:
            trail.append(RungAttempt(rung=i, reason=reason, config=cfg,
                                     outcome="plan-error", error=str(e)))
            continue
        u, s, vh, health = p.svd_verified(a)
        verdict = _health.judge_plan(p, health, orth_tol=orth_tol)
        if verdict.ok:
            trail.append(RungAttempt(rung=i, reason=reason, config=cfg,
                                     outcome="passed", verdict=verdict))
            return u, s, vh, tuple(trail)
        trail.append(RungAttempt(rung=i, reason=reason, config=cfg,
                                 outcome="failed", verdict=verdict))
    raise SolveFailure(tuple(trail))
