"""Zolo-PD: polar decomposition via composed Zolotarev functions.

Port of ``repro/core/zolo.py`` (paper Algorithm 1): one iteration body,
:func:`zolo_iteration`, under two schedule sources — the static
precomputed schedule (:func:`run_schedule`) and the dynamic run-time
coefficients with a residual stop (:func:`run_dynamic`) — with its hot
loops routed through an injectable :class:`ZoloOps` bundle: the default
plain torch ops here, the hand-written CUDA kernels in
:mod:`repro_torch.core.zolo_cuda`.

Within one address space the Gram product ``G = X^T X`` is computed once
per iteration and shared by the r shifted factorizations
``Z_j = G + c_{2j-1} I`` (Gram sharing).  The first (ill-conditioned)
iteration uses a QR of ``[X; sqrt(c) I]`` — the paper-faithful blocked
structured Householder QR (:mod:`repro_torch.core.structured_qr`) or the
shifted CholeskyQR2 — picked by ``qr_mode``; the rest the shared-Gram
Cholesky term.

Differences from the JAX reference, each deliberate:

* ``torch.linalg.cholesky`` raises on an indefinite matrix where
  ``jnp.linalg.cholesky`` returns NaN; :func:`_cholesky`
  (:func:`repro_torch.core.linalg.cholesky`) NaN-fills the failed batch
  entries instead, so the failure mode (NaN factors) matches.
* The Householder term runs its r structured QRs one after another, as
  the reference does (a batched r = 4 stack would hold four (m+n) x n
  stacks, ~4 x 3 GB at n = 12,000).
* Every triangular solve is a *left* solve on transposed operands
  (``X^T``, ``Q1^T``): the reference's chol term already has this form,
  and its CholeskyQR2 right-solves ``Q1 = X L^{-T}`` are the same
  arithmetic as ``Q1^T = L^{-1} X^T``.  torch's solvers return LAPACK's
  column-major layout, so the transposed views of their (r, n, m)
  results are row-major (r, m, n) stacks — the layout the Gram and
  combine kernels read — without a copy.
* The ``(r, ...)`` broadcast of X before the solves materialises in
  torch (one (r, n, m) copy per iteration); it counts in peak memory.
* The dynamic loop is a host ``while`` loop, not a ``lax.while_loop``:
  see :func:`run_dynamic`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import coeffs as _coeffs
from repro_torch.core import linalg as _linalg
from repro_torch.core import norms as _norms
from repro_torch.core.qdwh import PolarInfo, form_h, upload
from repro_torch.core.structured_qr import \
    structured_qr_q1q2 as _structured_qr_q1q2
from repro_torch.kernels import ref as _kref

# The shift clamp and the plain shifted Gram are the Gram kernel's plain
# version (one definition for the engine and the kernel):
# _clamp_shift(c_odd, g, dtype) ridges positive shifts of itemsize <= 4
# iterates against the global max diagonal of g (f64 untouched), and
# _gram(x, c=0.0) is X^T X (+ c I) with f32-or-better accumulation.
SHIFT_RIDGE_FACTOR = _kref.SHIFT_RIDGE_FACTOR
_clamp_shift = _kref.clamp_shift
_gram = _kref.gram_ref


def _polar_update(x, t, a, mhat):
    """X2 = mhat * (X + sum_j a_j T_j) over stacked terms t: (r, ..., m, n).

    The combine runs at the term dtype (f32-or-better) and the result is
    cast back to the iterate dtype, so a bf16 iterate stays bf16."""
    s = torch.einsum("j,j...mn->...mn", a.to(t.dtype), t)
    return (mhat * (x + s)).to(x.dtype)


def _coeff_select_all(c_odd, a):
    """Default coefficient selector: this executor evaluates all r terms."""
    return c_odd, a


class ZoloOps(NamedTuple):
    """Injectable compute ops for the Zolotarev iteration hot spots.

    * ``gram(x, c=0.0)``          -> X^T X + c I, f32-or-better.
    * ``gram_local(q, c=0.0)``    -> the same for a replicated operand
      (CholeskyQR2's identity block); single-address-space bundles point
      it at ``gram``.
    * ``polar_update(x, t, a, mhat)`` -> mhat * (X + sum_j a[j] T[j]).
    * ``coeff_select(c_odd, a)``  -> the (c_odd, a) slice this executor
      evaluates (the dynamic and grouped engines use it).
    * ``fnorm(x)`` / ``fnorm_pair(a, b)`` -> Frobenius norms for the
      dynamic engine's residual test.
    """

    gram: Callable = _gram
    polar_update: Callable = _polar_update
    gram_local: Callable = _gram
    coeff_select: Callable = _coeff_select_all
    fnorm: Callable = _norms.frobenius
    fnorm_pair: Callable = _norms.frobenius_pair


DEFAULT_OPS = ZoloOps()


# lower Cholesky factor, all-NaN for an entry that is not positive definite
_cholesky = _linalg.cholesky


def _first_pass_ridge(z, c_eff, dtype):
    """Raise the shifts of the first CholeskyQR2 pass's Z_j = G + c_eff_j I
    to at least sqrt(n) * SHIFT_RIDGE_FACTOR * eps(accum) * max diag Z,
    the largest diagonal entry over all r shifted matrices (>= max diag
    G), for iterates of itemsize <= 4; f64 is untouched.

    The rounding noise in the eigenvalues of an f32 n x n Gram grows like
    sqrt(n), and the clamp floor (8 eps max diag G, set at n = 256) does
    not: at the paper's linverse (n = 11,999, kappa = 9.06e3) the Gram
    kernel's G has lambda_min = -2.1e-7 against c_eff = 5.8e-8 (measured
    on an H100), so Z is indefinite and its Cholesky fails.  In this pass
    Z only preconditions: pass 2 factorizes [X; sqrt(c) I] R1^{-1} with
    the exact c, so (R2 R1)^T (R2 R1) = X^T X + c I and the term is the
    same in exact arithmetic whatever ridge R1 was built with."""
    if dtype.itemsize > 4:
        return z
    n = z.shape[-1]
    diag_max = torch.amax(torch.diagonal(z, dim1=-2, dim2=-1))
    rho = (n ** 0.5 * SHIFT_RIDGE_FACTOR
           * torch.finfo(_kref.accum_dtype(dtype)).eps
           * torch.clamp(diag_max, min=0.0))
    extra = torch.clamp(rho - c_eff, min=0.0)
    return z + extra[:, None, None] * torch.eye(n, dtype=z.dtype,
                                                device=z.device)


def _solve_lower(l, b):
    """L^{-1} B (left solve, lower triangular)."""
    return _linalg.solve_triangular(l, b, upper=False)


def _chol_terms(x, c_odd, gram=None, *, ops: ZoloOps = DEFAULT_OPS):
    """W_j = Z_j^{-1} X^T for all j, with Z_j = X^T X + c_{2j-1} I.

    Returns W with shape (r, ..., n, m) (transposed terms); ``W.mT`` is
    the stacked (r, ..., m, n) terms X Z_j^{-1}."""
    m, n = x.shape[-2:]
    # factorizations run at f32-or-better whatever the iterate dtype
    fdtype = _kref.accum_dtype(x.dtype)
    r = c_odd.shape[0]
    if gram is None and r == 1:
        # single-term executor: fold the shift into the Gram call so the
        # gram implementation applies the shift clamp
        z = ops.gram(x, c_odd.to(fdtype)[0])[None].to(fdtype)
    else:
        g = (ops.gram(x) if gram is None else gram).to(fdtype)
        eye = torch.eye(n, dtype=fdtype, device=x.device)
        c_eff = _clamp_shift(c_odd.to(fdtype), g, x.dtype)
        z = g[None] + c_eff[:, None, None] * eye  # (r, n, n)
    l = _cholesky(z)
    xt = x.mT.to(fdtype).expand((r,) + x.shape[:-2] + (n, m))
    # Z^{-1} X^T = L^{-T} (L^{-1} X^T), (r, n, m) in fdtype
    return _linalg.solve_triangular(l.mT, _solve_lower(l, xt), upper=True)


def term_sum_chol(x, c_odd, a, gram=None, *, ops: ZoloOps = DEFAULT_OPS):
    """sum_j a_j X (X^T X + c_{2j-1} I)^{-1} — the Cholesky-variant
    Zolotarev term (the drivers go through :func:`zolo_iteration`)."""
    w = _chol_terms(x, c_odd, gram=gram, ops=ops)
    return torch.einsum("j,jnm->mn", a.to(w.dtype), w).to(x.dtype)


def term_sum_cholqr2(x, c_odd, a, *, ops: ZoloOps = DEFAULT_OPS):
    """sum_j (a_j / sqrt(c_j)) Q1_j Q2_j^T via shifted CholeskyQR2 of
    [X; sqrt(c_j) I] (eq. 12 analogue).

    Q1_j = X R_j^{-1}, Q2_j = sqrt(c_j) R_j^{-1} with R_j = L_j^T from a
    two-pass shifted Cholesky QR.  Both are carried transposed
    (Q1^T = L^{-1} X^T, Q2^T = sqrt(c) L^{-1}); the second-pass Gram is
    ``ops.gram(Q1) + ops.gram_local(Q2)``."""
    m, n = x.shape[-2:]
    fdtype = _kref.accum_dtype(x.dtype)
    r = c_odd.shape[0]
    c_odd_f = c_odd.to(fdtype)
    sqrt_c = torch.sqrt(c_odd_f)
    eye = torch.eye(n, dtype=fdtype, device=x.device)

    if r == 1:
        # fused shifted Gram: the gram implementation clamps the shift
        z = ops.gram(x, c_odd_f[0])[None].to(fdtype)
        c_eff = _clamp_shift(c_odd_f, z[0], x.dtype)
    else:
        g = ops.gram(x).to(fdtype)
        c_eff = _clamp_shift(c_odd_f, g, x.dtype)
        z = g[None] + c_eff[:, None, None] * eye
    l1 = _cholesky(_first_pass_ridge(z, c_eff, x.dtype))  # R1 = L1^T
    xt = x.mT.to(fdtype).expand((r,) + x.shape[:-2] + (n, m))
    q1t = _solve_lower(l1, xt)                           # (X R1^{-1})^T
    q2t = sqrt_c[:, None, None] * _solve_lower(l1, eye.expand(r, n, n))
    # second pass restores orthogonality: G2 = Q1^T Q1 + Q2^T Q2, with the
    # Grams at the iterate dtype (a no-op cast for f32/f64)
    g2 = (ops.gram(q1t.mT.to(x.dtype))
          + ops.gram_local(q2t.mT.to(x.dtype))).to(fdtype)
    l2 = _cholesky(g2)
    q1t = _solve_lower(l2, q1t)
    q2t = _solve_lower(l2, q2t)
    return torch.einsum("j,jkm,jkn->mn", a.to(fdtype) / sqrt_c, q1t, q2t)


def term_sum_householder(x, c_odd, a, block: int = 32, *,
                         ops: ZoloOps = DEFAULT_OPS):
    """sum_j (a_j / sqrt(c_j)) Q1_j Q2_j^T via the blocked *structured*
    Householder QR of [X; sqrt(c_j) I] (MPDGEQRF/MPDORGQR analogue, §3.1)
    over the given odd-coefficient slice, one term after another.

    ``ops`` is accepted for term-signature uniformity only: the blocked
    Householder QR has no kernel, so its products run as torch ops (in
    f32-or-better: a bf16 iterate's term runs in f32)."""
    dtype = _kref.accum_dtype(x.dtype)
    x = x.to(dtype)
    total = None
    for j in range(c_odd.shape[0]):
        q1, q2 = _structured_qr_q1q2(x, torch.sqrt(c_odd[j]).to(dtype),
                                     block=block)
        term = (a[j] / torch.sqrt(c_odd[j])).to(dtype) * (q1 @ q2.mT)
        del q1, q2
        total = term if total is None else total.add_(term)
    return total


ITER_MODES = ("chol", "cholqr2", "householder")


def _validate_iter_mode(name: str, value: str, extra=()) -> None:
    """ValueError for an unknown iteration mode, listing the valid ones."""
    valid = sorted(ITER_MODES) + list(extra)
    if value not in valid:
        raise ValueError(f"unknown {name}: {value!r} (one of {valid})")


def zolo_iteration(x, c_odd, a, mhat, *, mode: str = "chol",
                   ops: ZoloOps = DEFAULT_OPS, hh_block: int = 32):
    """THE Zolotarev iteration body (Alg. 1 step 4):
    X -> mhat * (X + sum_j a_j T_j(c_{2j-1})), with the shifted
    factorization for T_j picked by ``mode``: "chol" (shared-Gram
    Cholesky), "cholqr2" (shifted CholeskyQR2) or "householder" (the
    blocked structured Householder QR, panels of ``hh_block`` columns)."""
    if mode == "chol":
        # (r, n, m) left-solve results are column-major, so the transposed
        # view is a row-major (r, m, n) stack: no copy before the combine
        t = _chol_terms(x, c_odd, ops=ops).mT
        return ops.polar_update(x, t, a, mhat)
    if mode == "cholqr2":
        # the QR-form terms fold the a_j weights into their sum, so the
        # combine sees one pre-summed term with unit weight
        t = term_sum_cholqr2(x, c_odd, a, ops=ops)
    elif mode == "householder":
        t = term_sum_householder(x, c_odd, a, block=hh_block, ops=ops)
    else:
        _validate_iter_mode("mode", mode)
    one = torch.ones((1,), dtype=_kref.accum_dtype(x.dtype), device=x.device)
    return ops.polar_update(x, t[None], one, mhat)


def run_schedule(x, c_odd, a_wts, mhats, *, qr_mode: str = "cholqr2",
                 qr_iters: int = 1, ops: ZoloOps = DEFAULT_OPS,
                 hh_block: int = 32):
    """THE static schedule source: the precomputed coefficient schedule,
    unrolled over :func:`zolo_iteration`.

    ``c_odd`` (iters, r) / ``a_wts`` (iters, r) / ``mhats`` (iters,) are
    the stacked per-iteration coefficients.  The first ``qr_iters``
    iterations use ``qr_mode``; the rest the shared-Gram Cholesky term."""
    for i in range(c_odd.shape[0]):
        mode = qr_mode if i < qr_iters else "chol"
        x = zolo_iteration(x, c_odd[i], a_wts[i], mhats[i], mode=mode,
                           ops=ops, hh_block=hh_block)
    return x


def _residual(ops: ZoloOps, x_new, x, dtype):
    """||X_new - X||_F / ||X_new||_F through ``ops.fnorm_pair`` (one fused
    reduction for both norms)."""
    nrm = ops.fnorm_pair(x_new - x, x_new)
    return nrm[0] / torch.clamp(nrm[1], min=torch.finfo(dtype).tiny)


def run_dynamic(x0, l0, r: int, *, eps: float, max_iters: int = 8,
                first_mode: str = "auto", hh_block: int = 32,
                ops: ZoloOps = DEFAULT_OPS, allow_householder: bool = True):
    """THE dynamic schedule source: Zolotarev coefficients computed at
    run time from the running lower bound (on the device, in ``l0``'s
    dtype), so one code path serves any conditioning.

    The *first* iteration is peeled off and picks its factorization by
    stability regime (the paper's QR-first policy):

      l0 <  10 sqrt(eps)  -> structured Householder QR (paper §3.1)
      l0 <  0.05          -> shifted CholeskyQR2
      else                -> shared-Gram Cholesky

    ``first_mode`` is "auto" (the rule above), "householder", "cholqr2"
    or "chol".  ``allow_householder=False`` substitutes the shifted
    CholeskyQR2 term in the extreme regime, as the reference defines it
    (for an executor that cannot run the structured QR).  The rest
    are shared-Gram Cholesky iterations, stopped by the paper's residual
    rule ||X_k+1 - X_k||_F / ||X_k+1||_F <= max(eps^(1/(2r+1)),
    4 eps(iterate)) or by ``max_iters``.

    Loop: a host ``while`` loop that reads the residual once per
    iteration (one device sync each), chosen over a fixed trip of
    ``max_iters`` with frozen state: it runs exactly the reference's
    iterations and no more, and one scalar read per iteration is nothing
    beside an iteration's factorizations.  The "auto" branch is decided
    on the host from ``l0`` the same way (the reference's ``lax.switch``
    index).  Returns ``(x, l_final, iterations, residual, converged)``;
    ``converged`` records whether the residual rule was met.
    """
    dtype = x0.dtype
    tol = max(eps ** (1.0 / (2 * r + 1)), 4.0 * torch.finfo(dtype).eps)
    hh_thresh = 10.0 * eps ** 0.5
    qr_thresh = 0.05

    # --- peeled first iteration ------------------------------------------
    c0, a0, m0 = _coeffs.zolo_coeffs(l0, r)
    mode = first_mode
    if first_mode == "auto":
        l0_host = float(l0)
        mode = ("chol" if l0_host >= qr_thresh else
                "cholqr2" if l0_host >= hh_thresh else
                "householder" if allow_householder else "cholqr2")
    c_sel, a_sel = ops.coeff_select(c0[0::2], a0)
    x1 = zolo_iteration(x0, c_sel, a_sel, m0, mode=mode, ops=ops,
                        hh_block=hh_block)
    res = _residual(ops, x1, x0, dtype)
    l = torch.clamp(_coeffs.zolo_l_update(l0, c0, m0), 0.0, 1.0 - eps)

    # --- remaining iterations: shared-Gram Cholesky ----------------------
    x, k = x1, 1
    while k < max_iters and float(res) > tol:  # NaN stops, unconverged
        c, av, mh = _coeffs.zolo_coeffs(l, r)
        c_sel, a_sel = ops.coeff_select(c[0::2], av)
        x_new = zolo_iteration(x, c_sel, a_sel, mh, mode="chol", ops=ops)
        res = _residual(ops, x_new, x, dtype)
        l = torch.clamp(_coeffs.zolo_l_update(l, c, mh), 0.0, 1.0 - eps)
        x, k = x_new, k + 1
    return x, l, k, res, res <= tol


def zolo_pd(a, r: int = 3, *, alpha=None, l=None, max_iters: int = 8,
            eps: Optional[float] = None, want_h: bool = True,
            first_mode: str = "auto", hh_block: int = 32,
            ops: Optional[ZoloOps] = None):
    """Dynamic Zolo-PD (paper Alg. 1) of ``a`` with m >= n — the (dynamic
    schedule, ``ops``) binding of the engine; it scales itself.

    ``alpha`` (default: the guaranteed ``sigma_max_upper`` bound) scales
    A to X0 = A / alpha; ``l`` (default: ``sigma_min_lower_qr(X0)``, in
    the iterate's f32-or-better dtype) is the lower bound the
    coefficients start from, clamped to [4 eps, 1 - eps].  A given ``l``
    (a python number) is taken as float64.  ``eps`` defaults to the
    accumulation precision's (f32 for a bf16 iterate).  H is formed from
    the unscaled ``a``.  Returns (Q, H or None, PolarInfo)."""
    _validate_iter_mode("first_mode", first_mode, extra=("auto",))
    ops = DEFAULT_OPS if ops is None else ops
    dtype = a.dtype
    eps = eps or torch.finfo(_kref.accum_dtype(dtype)).eps
    alpha = _norms.sigma_max_upper(a) if alpha is None else \
        torch.as_tensor(alpha, device=a.device)
    x0 = a / alpha.to(dtype)
    if l is None:
        l0 = _norms.sigma_min_lower_qr(x0)
    elif isinstance(l, torch.Tensor):
        l0 = l.to(a.device)
    else:
        l0 = torch.tensor(float(l), dtype=torch.float64, device=a.device)
    l0 = torch.clamp(l0, 4 * eps, 1.0 - eps)
    x, l_fin, k, res, conv = run_dynamic(x0, l0, r, eps=eps,
                                         max_iters=max_iters,
                                         first_mode=first_mode,
                                         hh_block=hh_block, ops=ops)
    info = PolarInfo(
        iterations=torch.tensor(k, dtype=torch.int32, device=a.device),
        residual=res, l_final=l_fin, converged=conv,
        l_init=l0.to(torch.float32))
    if want_h:
        return x, form_h(x, a), info
    return x, None, info


def zolo_pd_static(a, *, l0: Optional[float] = None,
                   r: Optional[int] = None, max_iters: int = 6,
                   want_h: bool = False, qr_mode: str = "cholqr2",
                   qr_iters: int = 1, hermitian_source=None,
                   schedule=None, ops: Optional[ZoloOps] = None,
                   hh_block: int = 32):
    """Unrolled Zolo-PD with a precomputed coefficient schedule — the
    (static schedule, ``ops``) binding of the engine.

    ``a`` must be pre-scaled (sigma_max <= 1) with singular values in
    [l0, 1].  The first ``qr_iters`` iterations use ``qr_mode``
    ("cholqr2" | "householder" | "chol", Householder panels of
    ``hh_block`` columns); the rest the shared-Gram Cholesky term.  A
    ``schedule`` (sequence of
    :class:`repro_torch.core.coeffs.ZoloIteration`, e.g. bound by an
    ``SvdPlan``) takes precedence over ``l0``/``r``/``max_iters``.
    Returns (Q, H or None, PolarInfo)."""
    _validate_iter_mode("qr_mode", qr_mode)
    ops = DEFAULT_OPS if ops is None else ops
    if schedule is not None:
        sched = list(schedule)
    elif l0 is not None:
        if r is None:
            r = _coeffs.choose_r(1.0 / float(l0))
        sched = _coeffs.zolo_schedule_np(float(l0), r, max_iters=max_iters)
    else:
        raise ValueError("zolo_pd_static needs l0= or a precomputed "
                         "schedule=")
    cdt = _kref.accum_dtype(a.dtype)
    dev = a.device
    c_odd = upload([it.c[0::2] for it in sched], cdt, dev)
    a_wts = upload([it.a for it in sched], cdt, dev)
    mhats = upload([it.mhat for it in sched], cdt, dev)
    x = run_schedule(a, c_odd, a_wts, mhats, qr_mode=qr_mode,
                     qr_iters=qr_iters, ops=ops, hh_block=hh_block)
    src = a if hermitian_source is None else hermitian_source
    f32 = torch.float32
    info = PolarInfo(
        iterations=torch.full((), len(sched), dtype=torch.int32, device=dev),
        residual=torch.zeros((), dtype=a.dtype, device=dev),
        l_final=torch.full((), sched[-1].l_after, dtype=f32, device=dev),
        converged=torch.ones((), dtype=torch.bool, device=dev),
        l_init=torch.full((), sched[0].l_before, dtype=f32, device=dev))
    if want_h:
        return x, form_h(x, src), info
    return x, None, info


def polar_canonical(a):
    """Return (a_work, transposed) with a_work.shape[-2] >= a_work.shape[-1].

    polar(A^T) = polar(A)^T for the orthogonal factor; callers transpose
    back.  The transposed work matrix is made contiguous here, once, so
    the kernels downstream see a row-major iterate."""
    m, n = a.shape[-2:]
    if m >= n:
        return a, False
    return a.mT.contiguous(), True
