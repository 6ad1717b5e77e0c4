"""Spectral-bound estimators for the polar-decomposition drivers.

Port of the main-path part of ``repro/core/norms.py``:

* ``sigma_max_upper`` — guaranteed upper bound
  min(sqrt(||A||_1 ||A||_inf), ||A||_F).
* ``sigma_max_power`` — power iteration (sharp, lower-biased).
* ``sigma_min_lower_qr`` — sigma_min lower estimate from one QR and
  inverse iteration on R (the dynamic engine's run-time bound).
* ``sigma_min_lower`` — the Gram route (one Cholesky, inverse
  iteration; its ``gram=`` hook takes a kernel's Gram).
* ``singular_interval`` / ``condition_estimate`` — the spectrum bracket
  the d&c top-k frontend bisects in, and a kappa over-estimate.

The reference draws the power iteration's start vector from
``jax.random.normal(PRNGKey(0))``, which torch cannot reproduce.  Here
the start vector is explicit (``v0``), or drawn from a ``torch.Generator``
(seed 0 on the input's device unless one is given).  The vector sets the
planner's prescale alpha, so parity tests hand both packages the same one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core import linalg as _linalg


def frobenius(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.abs(a) ** 2))


def frobenius_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(||a||_F, ||b||_F) as one stacked length-2 vector (the
    ``ZoloOps.fnorm_pair`` slot; distributed bundles fuse both sums)."""
    return torch.sqrt(torch.stack([torch.sum(torch.abs(a) ** 2),
                                   torch.sum(torch.abs(b) ** 2)]))


def sigma_max_upper(a: torch.Tensor) -> torch.Tensor:
    """Guaranteed upper bound on sigma_max:
    min(sqrt(||A||_1 ||A||_inf), ||A||_F)."""
    n1 = torch.amax(torch.sum(torch.abs(a), dim=-2))
    ninf = torch.amax(torch.sum(torch.abs(a), dim=-1))
    return torch.minimum(torch.sqrt(n1 * ninf), frobenius(a))


def sigma_max_power(a: torch.Tensor, iters: int = 10, *,
                    v0: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    reduce: Optional[Callable] = None):
    """Power iteration on A^T A; sharp estimate of sigma_max (lower-biased,
    so callers wanting a bound multiply by a safety factor).

    ``v0`` is the start vector (shape (..., n)); without it a Gaussian
    one is drawn from ``generator`` — by default a fresh one seeded with 0
    on ``a``'s device, so repeated calls agree.

    ``reduce`` makes ``a`` one row block of a matrix split over ranks: it
    sums a partial result over them (an all-reduce), and is applied to
    each A^T (A v) — a contraction over rows — and to the final sum of
    squares, so every rank gets the whole matrix's estimate."""
    n = a.shape[-1]
    if v0 is None:
        if generator is None and a.device.type != "meta":
            # (a meta tensor's draw holds no data: no generator needed)
            generator = torch.Generator(device=a.device).manual_seed(0)
        v = torch.randn(a.shape[:-2] + (n,), generator=generator,
                        dtype=a.dtype, device=a.device)
    else:
        v = v0.to(device=a.device, dtype=a.dtype).expand(
            a.shape[:-2] + (n,))
    tiny = torch.finfo(a.dtype).tiny
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        w = torch.einsum("...mn,...n->...m", a, v)
        u = torch.einsum("...mn,...m->...n", a, w)
        if reduce is not None:
            u = reduce(u)
        v = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1,
                                                     keepdim=True), min=tiny)
    av = torch.einsum("...mn,...n->...m", a, v)
    if reduce is None:
        return torch.linalg.vector_norm(av, dim=-1)
    return torch.sqrt(reduce(torch.sum(av * av, dim=-1)))


def sigma_min_lower(x: torch.Tensor, iters: int = 8, safety: float = 0.5,
                    *, gram=None) -> torch.Tensor:
    """Deflated estimate of sigma_min(X) for X with sigma_max <= ~1.

    Inverse power iteration on G = X^T X + delta I via one Cholesky,
    delta = n * eps keeps the factorization well-posed even for singular
    X.  Never returns below sqrt(delta) * safety (the resolution floor).
    The Gram accumulates in f32-or-better and the iteration runs in that
    dtype (a bf16 input would otherwise push the floor to ~0.5); the
    result is in the promoted dtype.

    ``gram`` swaps the Gram product for an implementation with the
    :class:`repro_torch.core.zolo.ZoloOps` ``gram(x)`` contract
    (f32-or-better accumulation), e.g. a kernel's or a distributed one."""
    n = x.shape[-1]
    dtype = torch.promote_types(x.dtype, torch.float32)
    eps = torch.finfo(dtype).eps
    delta = n * eps
    if gram is None:
        xa = x.to(dtype)
        g = xa.mT @ xa
    else:
        g = gram(x).to(dtype)
    g = g + delta * torch.eye(n, dtype=dtype, device=x.device)
    l = _linalg.cholesky(g)

    def solve(v):
        y = torch.linalg.solve_triangular(l, v[..., None], upper=False)
        z = torch.linalg.solve_triangular(l.mT, y, upper=True)
        return z[..., 0]

    tiny = torch.finfo(dtype).tiny
    v = torch.ones(x.shape[:-2] + (n,), dtype=dtype,
                   device=x.device) / math.sqrt(n)
    for _ in range(iters):
        w = solve(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                     keepdim=True), min=tiny)
    lam = torch.einsum("...n,...n->...", v,
                       torch.einsum("...kn,...n->...k", g, v))
    sig2 = torch.clamp(lam - delta, min=delta)
    return safety * torch.sqrt(sig2)


def sigma_min_lower_qr(x: torch.Tensor, iters: int = 12,
                       safety: float = 0.5) -> torch.Tensor:
    """sigma_min lower estimate via one QR + inverse iteration on R.

    Never squares the condition number, so it resolves sigma_min down to
    ~eps * sigma_max.  bf16/f16 inputs promote to f32 up front (the
    result is in the promoted dtype).  Deterministic: the inverse
    iteration starts from the all-ones vector.  An exactly singular R
    sends the solves to inf/NaN; the estimate then falls to the floor
    4 eps, never NaN."""
    n = x.shape[-1]
    dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dtype)
    r = torch.linalg.qr(x, mode="r")[1]

    def solve(v):
        # w = R^{-1} R^{-T} v  (power iteration on (R^T R)^{-1})
        y = torch.linalg.solve_triangular(r.mT, v[..., None], upper=False)
        z = torch.linalg.solve_triangular(r, y, upper=True)
        return z[..., 0]

    tiny = torch.finfo(dtype).tiny
    v = torch.ones(x.shape[:-2] + (n,), dtype=dtype,
                   device=x.device) / math.sqrt(n)
    for _ in range(iters):
        w = solve(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1,
                                                     keepdim=True), min=tiny)
    mu = torch.linalg.vector_norm(solve(v), dim=-1)  # ~ 1 / sigma_min^2
    sig = 1.0 / torch.sqrt(torch.clamp(mu, min=tiny))
    eps = torch.finfo(dtype).eps
    sig = torch.where(torch.isfinite(sig), sig, torch.zeros_like(sig))
    return torch.clamp(safety * sig, min=4 * eps)


def singular_interval(a: torch.Tensor, iters: int = 8):
    """(lower, upper) bracket of the singular spectrum of ``a``.

    ``upper`` is the guaranteed :func:`sigma_max_upper` bound; ``lower``
    the deflated :func:`sigma_min_lower` estimate of the pre-scaled
    matrix, mapped back to the original scale.  The spectral
    divide-and-conquer frontend (:mod:`repro_torch.spectral.dnc`) seeds
    its shift bisection with it: every spectrum-splitting shift lives in
    [lower**2, upper**2] on the Gram's eigenvalue axis.  Both ends are
    0-d tensors on ``a``'s device (``lower`` in f32-or-better)."""
    upper = sigma_max_upper(a)
    safe = torch.clamp(upper, min=torch.finfo(a.dtype).tiny)
    x0 = a / safe.to(a.dtype)
    lower = sigma_min_lower(x0, iters=iters) * safe
    return lower, upper


def condition_estimate(a: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """kappa_2 estimate: (upper bound on sigma_max) / (lower bound on
    sigma_min), an over-estimate — safe to feed the Zolotarev interval
    [1/kappa, 1].  sigma_min goes through the QR estimator: the Gram
    route squares the condition number and floors near sqrt(n * eps)."""
    amax = sigma_max_upper(a)
    x0 = a / amax.to(a.dtype)
    smin = sigma_min_lower_qr(x0, iters=iters)
    return 1.0 / smin
