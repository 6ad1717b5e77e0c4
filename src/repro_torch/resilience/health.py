"""Solve health: the cheap runtime verdict every plan can emit.

Port of ``repro/resilience/health.py``.  The failure modes the repo has
measured — an f32 Gram gone indefinite (NaN factors), a dynamic driver
stopping at ``max_iters`` with the residual rule unmet, a runtime
conditioning estimate beyond a kernel's precision envelope — all return
factors that look plausible.  :func:`solve_health` checks them on the
device: one extra Gram product (the ``UᵀU`` orthogonality residual —
the paper's OrthL metric, eq. 14) plus three scalar reductions, queued
behind the solve with no read back to the host.
``SvdPlan.svd_verified`` appends it to the solve.

The host-side half — :func:`judge` / :func:`judge_plan` — turns the
device scalars into a frozen :class:`HealthVerdict` with readable
reasons; it is the one sync.  The escalation ladder
(:mod:`repro_torch.resilience.escalate`) keys on ``verdict.ok`` and never
inspects raw floats itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import registry as _registry


class SolveHealth(NamedTuple):
    """Device-side health scalars (0-d tensors on the solve's device).

    ``svd_batched_verified`` returns one whose leaves carry the batch
    axes, so a caller indexes per-entry health out of it.
    """

    finite: torch.Tensor     # bool: all of u, s, vh finite
    orth: torch.Tensor       # f32: ||UᵀU - I||_F / n  (paper OrthL)
    converged: torch.Tensor  # bool: the driver's stopping rule was met
    kappa_est: torch.Tensor  # f32: 1 / l_init — the conditioning the
                             # solve actually ran under; NaN when unknown


def solve_health(u, s, vh, info=None) -> SolveHealth:
    """Health of an SVD result, computed on the device without a sync.

    The orthogonality residual is masked to the columns whose singular
    values clear a rank-revealing cutoff (``max(m, n) * eps * s_max``):
    null-space columns of a rank-deficient input — a zero-padded
    matrix's — are an arbitrary completion the algorithm never promised
    to orthonormalize, and the columns that carry the answer are exactly
    the ones the check must hold to eps.  The Gram accumulates in
    f32-or-better; every leaf keeps the input's leading batch axes.
    """
    finite = (torch.isfinite(u).all(dim=-1).all(dim=-1)
              & torch.isfinite(s).all(dim=-1)
              & torch.isfinite(vh).all(dim=-1).all(dim=-1))
    m, n = u.shape[-2], u.shape[-1]
    acc = torch.promote_types(u.dtype, torch.float32)
    ua = u.to(acc)
    g = torch.einsum("...mk,...mn->...kn", ua, ua)
    cutoff = (max(m, n) * torch.finfo(u.dtype).eps
              * torch.amax(s, dim=-1, keepdim=True))
    valid = s > cutoff          # NaN s -> all-False; `finite` still fails
    mask = valid[..., :, None] & valid[..., None, :]
    n_valid = torch.clamp(valid.sum(dim=-1), min=1)
    eye = torch.eye(n, dtype=acc, device=u.device)
    resid = torch.where(mask, g - eye, torch.zeros((), dtype=acc,
                                                   device=u.device))
    fro = torch.sqrt(torch.sum(resid * resid, dim=(-2, -1)))
    orth = (fro / n_valid).to(torch.float32)
    if info is not None:
        converged = torch.as_tensor(info.converged, device=u.device)
        l_init = torch.as_tensor(info.l_init, dtype=torch.float32,
                                 device=u.device)
        kappa_est = (1.0 / l_init).to(torch.float32)
    else:
        converged = torch.tensor(True, device=u.device)
        kappa_est = torch.tensor(float("nan"), dtype=torch.float32,
                                 device=u.device)
    return SolveHealth(finite=finite, orth=orth, converged=converged,
                       kappa_est=kappa_est)


def default_orth_tol(dtype) -> float:
    """Orthogonality acceptance threshold for a compute dtype.

    A healthy Zolo/QDWH solve lands at a small multiple of eps (paper
    Tables 5/10: OrthL within ~10 eps); a broken one is off by many
    orders.  1e4 * eps splits the two regimes with wide margin on both
    sides (f64 ~2e-12, f32 ~1e-3).  Sub-f32 dtypes need a far tighter
    multiplier: 1e4 * eps(bf16) = 78 would accept anything, while a
    healthy bf16 solve (f32 accumulation, factors rounded to bf16)
    measures orth ~ 1-2 eps(bf16) and a broken one >= O(1), so 8 * eps
    (~0.06 for bf16) splits those regimes."""
    mult = 1.0e4 if dtype.itemsize >= 4 else 8.0
    return mult * float(torch.finfo(dtype).eps)


@dataclasses.dataclass(frozen=True)
class HealthVerdict:
    """Host-side judgment of one solve: ``ok`` plus why not."""

    ok: bool
    reasons: Tuple[str, ...]
    finite: bool
    orth: float
    converged: bool
    kappa_est: float
    orth_tol: float
    kappa_max: Optional[float] = None

    def __str__(self):
        if self.ok:
            return f"healthy (orth={self.orth:.2e})"
        return "unhealthy: " + "; ".join(self.reasons)


def judge(health: SolveHealth, *, orth_tol: float,
          kappa_max: Optional[float] = None) -> HealthVerdict:
    """Turn device health scalars into a frozen verdict (host side; the
    one sync).

    ``kappa_max`` folds a backend's precision envelope into the runtime
    verdict: a dynamic plan has no conditioning hint at plan time, so
    the plan-time envelope check cannot fire — but the run-time estimate
    (``kappa_est = 1/l_init``) exists at execution time, and exceeding
    the envelope there is a health failure even if the factors happen
    to look finite.  A NaN ``kappa_est`` (driver with no bound) passes.
    """
    finite = bool(health.finite)
    orth = float(health.orth)
    converged = bool(health.converged)
    kappa_est = float(health.kappa_est)
    reasons = []
    if not finite:
        reasons.append("non-finite factors")
    if not (orth <= orth_tol):  # NaN-propagating: NaN orth also fails
        reasons.append(f"orthogonality {orth:.3e} > tol {orth_tol:.3e}")
    if not converged:
        reasons.append("stopping rule unmet at the iteration cap")
    if kappa_max is not None and not math.isnan(kappa_est) \
            and kappa_est > kappa_max:
        reasons.append(f"runtime kappa estimate {kappa_est:.3g} beyond "
                       f"the backend envelope {kappa_max:.3g}")
    return HealthVerdict(ok=not reasons, reasons=tuple(reasons),
                         finite=finite, orth=orth, converged=converged,
                         kappa_est=kappa_est, orth_tol=orth_tol,
                         kappa_max=kappa_max)


def judge_plan(plan, health: SolveHealth, *,
               orth_tol: Optional[float] = None) -> HealthVerdict:
    """Judge one solve against its plan's own contract.

    The orthogonality tolerance comes from the precision the solve
    actually computed in (``plan.compute_dtype``: the config's
    ``compute_dtype`` when set, the plan dtype otherwise), and the
    conditioning envelope from the backend's registry spec resolved per
    compute dtype (:func:`repro_torch.core.registry.envelope_kappa_max`:
    the ``kappa_envelope`` table entry for sub-f32 inputs,
    ``kappa_max_f32`` for f32, nothing for f64) — the registry drives the
    check, never the backend's name.
    """
    dtype = plan.compute_dtype
    if orth_tol is None:
        orth_tol = default_orth_tol(dtype)
    spec = _registry.get_polar(plan.method)
    kappa_max = _registry.envelope_kappa_max(spec, dtype)
    return judge(health, orth_tol=orth_tol, kappa_max=kappa_max)
