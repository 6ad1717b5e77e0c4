"""Spectral divide-and-conquer top-k frontend (paper §2.2 turned inward).

Port of ``repro/spectral/dnc.py``.  Zolo-SVD's eigensolver route splits a
symmetric matrix's spectrum with the matrix sign function: for
C = A^T A and a shift s,

    Q = sign(C - s I)           (polar factor of the symmetric
                                 indefinite C - s I — every registered
                                 polar backend computes exactly this)
    P = (I + Q) / 2             (spectral projector onto eigenvalues > s)
    trace(P) = #{ eigenvalues of C above s }.

The *top-k* workload only needs the split point moved until the upper
invariant subspace has width in [k, l]: a bisection on s, each probe one
polar solve through a cached dynamic :class:`repro_torch.solver.SvdPlan`
(``l0_policy="runtime"``: the shift changes per probe, so the
conditioning is only known at run time).  The bracket comes from
:func:`repro_torch.core.norms.singular_interval` squared.

Once a window shift is found, V1 = CholeskyQR2(P G) for an n x l probe
G, and Rayleigh-Ritz through B = A V1 (m x l) returns the leading
triplets.  A cluster of equal singular values straddling every
candidate split leaves no valid window; that is reported in
``info["converged"]`` rather than silently mis-ranked.

Difference from the reference: the bisection is a host loop with one
sync per probe (the probe's count is read to steer the next shift),
where the reference runs it as an in-graph ``lax.while_loop`` — the
dynamic engines' settled choice.  The probe G is passed in (drawn by
the plan), so a test can hand in the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core import norms as _norms
from repro_torch.core.structured_qr import cholesky_qr2


def count_above(q_sign):
    """#{eigenvalues above the shift} from the sign factor: trace of the
    spectral projector (I + Q)/2, i.e. (n + trace(Q)) / 2."""
    n = q_sign.shape[-1]
    return (n + torch.diagonal(q_sign, dim1=-2, dim2=-1).sum(-1)) / 2.0


def bisect_shift(c, k: int, l: int, sign_fn, lo2, hi2,
                 max_rounds: int = 12):
    """Bisection for a shift s with k <= trace(P(s)) <= l.

    ``c`` is the (n, n) Gram, ``sign_fn(x) -> sign(x)`` the polar solve
    of a cached dynamic plan, [lo2, hi2] the eigenvalue bracket (0-d
    tensors).  Bisection is geometric — C's spectrum spans kappa^2, so
    the split candidates are log-uniform.  Each probe's count is read
    on the host (one sync per probe) to pick the next shift.

    Returns (q_best, shift_best, count_best, converged, rounds): the
    shift a 0-d tensor in ``c``'s dtype, the rest host values.  The
    running best is the *widest window not exceeding l*: if no probe
    lands in [k, l] (clustered spectrum, or rank < k with every
    above-zero count short of k) the caller still gets the projector
    capturing the most leading directions that fit the extraction width.
    """
    n = c.shape[-1]
    dtype = c.dtype
    eps = torch.finfo(dtype).eps
    lo2 = torch.maximum(lo2, (eps * torch.clamp(hi2, min=1.0)) ** 2)
    eye = torch.eye(n, dtype=dtype, device=c.device)

    def probe(shift):
        q = sign_fn(c - shift.to(dtype) * eye)
        return q, float(count_above(q))

    # Seed the running best with the lower bracket edge: count there is
    # the closest thing to rank(C) the bracket knows, so the k >= rank
    # fallback is already in hand before the loop refines anything.
    q0, cnt0 = probe(lo2)
    best_cnt = cnt0 if cnt0 <= l else -float("inf")
    q_best, s_best = q0, lo2
    lo, hi = lo2, hi2
    rounds = 0
    while rounds < max_rounds and not (k <= best_cnt <= l):
        s = torch.exp(0.5 * (torch.log(lo) + torch.log(hi)))
        q, cnt = probe(s)
        # count too big -> window too wide -> raise the shift
        if cnt > l:
            lo = s
        if cnt < k:
            hi = s
        if cnt <= l and cnt > best_cnt:
            q_best, s_best, best_cnt = q, s, cnt
        rounds += 1
    # -inf best means even the bracket's lower edge over-counted; fall
    # back to that probe so extraction still sees a projector.
    if best_cnt == -float("inf"):
        q_best, best_cnt = q0, cnt0
    converged = k <= best_cnt <= l
    return q_best, s_best, best_cnt, converged, rounds


def dnc_topk(a, *, k: int, l: int, probe, sign_fn, small_svd,
             max_rounds: int = 12):
    """Leading-k SVD of canonical-tall ``a`` by spectral window + exact
    Rayleigh-Ritz.

    ``probe`` is the (n, l) Gaussian extraction probe G, ``sign_fn``
    computes the matrix sign of a symmetric (n, n) input (a dynamic
    polar plan) and ``small_svd`` factorizes the (m, l) extracted panel.
    Returns (u, s, vh, info) with info carrying the bisection telemetry
    (converged / count / shift / rounds).
    """
    n = a.shape[-1]
    dtype = a.dtype
    acc = torch.promote_types(dtype, torch.float32)
    aa = a.to(acc)
    c = (aa.mT @ aa).to(dtype)
    smin, smax = _norms.singular_interval(a)
    q_sign, shift, cnt, converged, rounds = bisect_shift(
        c, k, l, sign_fn, (smin ** 2).to(dtype),
        (smax ** 2).to(dtype) * (1 + 4 * torch.finfo(dtype).eps),
        max_rounds=max_rounds)

    # Spectral projector -> orthonormal window basis -> Rayleigh-Ritz.
    p = 0.5 * (q_sign + torch.eye(n, dtype=dtype, device=a.device))
    v1 = cholesky_qr2((p.to(acc) @ probe.to(acc)).to(dtype))
    b = a @ v1
    u_b, s, vh_b = small_svd(b)
    u = u_b[..., :, :k]
    vh = vh_b[..., :k, :] @ v1.mT
    info = {"converged": converged, "count": cnt, "shift": shift,
            "rounds": rounds}
    return u, s[..., :k], vh, info


def dnc_flops(m: int, n: int, k: int, l: int, rounds: int,
              sign_flops: float, small_flops: float = 0.0) -> float:
    """Flop model: Gram + ``rounds`` sign probes (each priced by the
    inner polar backend's own cost model) + projected-probe extraction +
    the (m, l) panel solve."""
    gram = 2.0 * m * n * n
    extract = 2.0 * n * n * l + 2.0 * (2.0 * n * l * l + l ** 3 / 3.0)
    panel = 2.0 * m * n * l
    return (gram + rounds * float(sign_flops) + extract + panel
            + float(small_flops))
