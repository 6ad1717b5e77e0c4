"""QDWH-PD: QR-based dynamically weighted Halley polar decomposition.

Port of ``repro/core/qdwh.py`` (paper §2.1, eqs. 2-4): the baseline the
paper compares Zolo-PD against, and the polar-decomposition record
``PolarInfo`` and Hermitian factor ``form_h`` every polar solver returns.

Two entry points:

* :func:`qdwh_pd`        — dynamic: coefficients from a run-time lower
                           bound ``l``; each iteration is the QR form
                           (eq. 3) while ``c_k > chol_switch`` (100, as
                           suggested in [31]/§2.1) and the Cholesky form
                           (eq. 4) after.
* :func:`qdwh_pd_static` — a precomputed (a, b, c, l) schedule, unrolled.

Both return ``(Q, H, info)`` with ``A = Q H``; ``want_h=False`` skips H.

Differences from the reference, each deliberate:

* The reference's ``lax.while_loop`` and its ``lax.cond(c > 100)`` are a
  host loop here that reads ``c`` and the residual once per iteration
  (two device syncs), the decision of
  :func:`repro_torch.core.zolo.run_dynamic`: it runs exactly the
  reference's iterations.
* The Cholesky is :func:`repro_torch.core.linalg.cholesky` (NaN for an
  indefinite Z, where ``torch.linalg.cholesky`` would raise).
* The QR form factors the dense (m+n) x n stack [sqrt(c) X; I] with
  ``torch.linalg.qr``, as the reference uses ``jnp.linalg.qr``; its Gram
  is a torch product, never the K1 kernel (the reference computes it
  outside any kernel too).
* Both iteration forms compute in f32-or-better and store the iterate
  back in its dtype, and :func:`qdwh_pd`'s ``eps`` defaults to the
  f32-or-better precision's, as in the Zolo engine.  For f32 and f64
  that is the reference's arithmetic; for a bf16 compute plan
  (``method="auto"`` picks ``qdwh_static`` there, as the reference's
  does) the reference's ``jnp.linalg.qr``/``cholesky`` refuse bf16 and
  the solve raises, where the port's runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core import coeffs as _coeffs
from repro_torch.core import linalg as _linalg
from repro_torch.core import norms as _norms
from repro_torch.kernels import ref as _kref


class PolarInfo(NamedTuple):
    """Convergence record of one polar solve (fields are tensors on the
    solve's device).

    ``converged`` is the runtime verdict a resilience layer keys on;
    static schedules are converged by construction.  ``l_init`` is the
    sigma_min lower bound the solve ran under (NaN when unknown).
    """

    iterations: torch.Tensor  # scalar int32
    residual: torch.Tensor    # final ||X2 - X1||_F / ||X2||_F
    l_final: torch.Tensor
    converged: torch.Tensor = True
    l_init: torch.Tensor = float("nan")


def form_h(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """H = (Q^T A + (Q^T A)^T) / 2 — the Hermitian polar factor."""
    with obs.span("svd.form_h"):
        qa = q.mT @ a
        return 0.5 * (qa + qa.mT)


def _qdwh_qr_iter(x, a, b, c):
    """Inverse-free QR iteration (eq. 3):
    X+ = (b/c) X + (a - b/c) / sqrt(c) Q1 Q2^T, computed in f32-or-better
    and returned in X's dtype."""
    m, n = x.shape[-2:]
    fdt = _kref.accum_dtype(x.dtype)
    xf = x.to(fdt)
    eye = torch.eye(n, dtype=fdt, device=x.device).expand(
        x.shape[:-2] + (n, n))
    stacked = torch.cat([torch.sqrt(c).to(fdt) * xf, eye], dim=-2)
    q, _ = torch.linalg.qr(stacked)
    q1 = q[..., :m, :]
    q2 = q[..., m:, :]
    coef = ((a - b / c) / torch.sqrt(c)).to(fdt)
    return ((b / c).to(fdt) * xf + coef * (q1 @ q2.mT)).to(x.dtype)


def _qdwh_chol_iter(x, a, b, c):
    """Cholesky iteration (eq. 4): Z = I + c X^T X,
    X+ = (b/c) X + (a - b/c) X Z^{-1}, computed in f32-or-better and
    returned in X's dtype."""
    n = x.shape[-1]
    fdt = _kref.accum_dtype(x.dtype)
    xf = x.to(fdt)
    z = c.to(fdt) * (xf.mT @ xf) + torch.eye(n, dtype=fdt, device=x.device)
    l = _linalg.cholesky(z)
    # W = Z^{-1} X^T by two triangular solves; X Z^{-1} = W^T
    y = _linalg.solve_triangular(l, xf.mT, upper=False)
    w = _linalg.solve_triangular(l.mT, y, upper=True)
    return ((b / c).to(fdt) * xf + (a - b / c).to(fdt) * w.mT).to(x.dtype)


def qdwh_pd(a, *, alpha=None, l=None, max_iters: int = 12,
            eps: Optional[float] = None, want_h: bool = True,
            chol_switch: float = 100.0):
    """Dynamic QDWH polar decomposition of ``a`` (m >= n).

    ``alpha`` (default: the guaranteed ``sigma_max_upper`` bound) scales
    A to X0 = A / alpha; ``l`` (default: ``sigma_min_lower_qr(X0)``; a
    python number is taken as float64) is clamped to [4 eps, 1 - eps].
    Stops when ||X_k+1 - X_k||_F / ||X_k+1||_F <= eps^(1/3) or after
    ``max_iters``.  Returns (Q, H or None, PolarInfo)."""
    dtype = a.dtype
    dev = a.device
    eps = eps or torch.finfo(_kref.accum_dtype(dtype)).eps
    alpha = _norms.sigma_max_upper(a) if alpha is None else \
        torch.as_tensor(alpha, device=dev)
    x = a / alpha.to(dtype)
    if l is None:
        l0 = _norms.sigma_min_lower_qr(x)
    elif isinstance(l, torch.Tensor):
        l0 = l.to(dev)
    else:
        l0 = torch.tensor(float(l), dtype=torch.float64, device=dev)
    l0 = torch.clamp(l0, 4 * eps, 1.0 - eps)
    tol = eps ** (1.0 / 3.0)
    tiny = torch.finfo(dtype).tiny
    lk, k = l0, 0
    res = torch.ones((), dtype=dtype, device=dev)
    while k < max_iters and float(res) > tol:  # NaN stops, unconverged
        ca, cb, cc = _coeffs.qdwh_coeffs(lk)
        if float(cc) > chol_switch:
            x_new = _qdwh_qr_iter(x, ca, cb, cc)
        else:
            x_new = _qdwh_chol_iter(x, ca, cb, cc)
        res = _norms.frobenius(x_new - x) / torch.clamp(
            _norms.frobenius(x_new), min=tiny)
        lk = torch.clamp(_coeffs.qdwh_l_update(lk, ca, cb, cc), 0.0, 1.0)
        x, k = x_new, k + 1
    info = PolarInfo(
        iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        residual=res, l_final=lk, converged=res <= tol,
        l_init=l0.to(torch.float32))
    if want_h:
        return x, form_h(x, a), info
    return x, None, info


def upload(values, dtype, device) -> torch.Tensor:
    """A host list as a ``dtype`` tensor on ``device``, without waiting for
    the device: the copy from pageable host memory is staged by CUDA
    at once (``non_blocking``), where a blocking copy (what
    ``torch.tensor(..., device=)`` makes) first synchronises the stream —
    a static solve would then hold the host until the card caught up."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def qdwh_pd_static(a, *, l0: Optional[float] = None, max_iters: int = 8,
                   want_h: bool = True, qr_iters: Optional[int] = None,
                   schedule=None):
    """Unrolled QDWH with a precomputed coefficient schedule from ``l0``.

    ``a`` must already be scaled so that sigma_max(a) <= 1.  ``qr_iters``:
    how many leading iterations use the QR form; default: while the
    schedule's ``c_k`` exceeds 100 (the paper's switch).  A precomputed
    ``schedule`` (rows ``(a, b, c, l)`` of
    :func:`repro_torch.core.coeffs.qdwh_schedule_np`, e.g. bound by an
    ``SvdPlan``) takes precedence over ``l0``/``max_iters``."""
    if schedule is not None:
        sched = list(schedule)
    elif l0 is not None:
        sched = _coeffs.qdwh_schedule_np(float(l0), max_iters=max_iters)
    else:
        raise ValueError("qdwh_pd_static needs l0= or a precomputed "
                         "schedule=")
    dev = a.device
    cdt = torch.promote_types(a.dtype, torch.float32)
    # the schedule staged in one copy and the info filled on the device
    coefs = upload([row[:3] for row in sched], cdt, dev)
    x = a
    for i, (_, _, cc, _) in enumerate(sched):
        use_qr = cc > 100.0 if qr_iters is None else i < qr_iters
        fa, fb, fc = coefs[i]
        if use_qr:
            x = _qdwh_qr_iter(x, fa, fb, fc)
        else:
            x = _qdwh_chol_iter(x, fa, fb, fc)
    f32 = torch.float32
    info = PolarInfo(
        iterations=torch.full((), len(sched), dtype=torch.int32, device=dev),
        residual=torch.zeros((), dtype=a.dtype, device=dev),
        l_final=torch.full((), sched[-1][3], dtype=f32, device=dev),
        converged=torch.ones((), dtype=torch.bool, device=dev),
        l_init=torch.full((), float(l0) if l0 is not None else float("nan"),
                          dtype=f32, device=dev))
    if want_h:
        return x, form_h(x, a), info
    return x, None, info
