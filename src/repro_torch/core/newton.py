"""Scaled Newton polar iteration (paper §2 intro; Higham 2008).

Port of ``repro/core/newton.py``:
X_{k+1} = (zeta_k X_k + X_k^{-T} / zeta_k) / 2 for a square nonsingular
A, with (1, inf)-norm scaling — the classical baseline the polar
decomposition literature compares against.

Differences from the reference, each deliberate: the ``lax.while_loop``
is a host loop that reads the residual once per iteration, and the
inverse is :func:`repro_torch.core.linalg.inv` (NaN for an exactly
singular iterate, where ``torch.linalg.inv`` would raise and
``jnp.linalg.inv`` returns inf/NaN).
"""

from __future__ import annotations

import torch

from repro_torch.core import linalg as _linalg
from repro_torch.core import norms as _norms
from repro_torch.core.qdwh import PolarInfo, form_h


def _norm1(x):
    return torch.amax(torch.sum(torch.abs(x), dim=-2))


def _norminf(x):
    return torch.amax(torch.sum(torch.abs(x), dim=-1))


def scaled_newton_pd(a, *, max_iters: int = 30, eps=None,
                     want_h: bool = True):
    """Polar decomposition of a square ``a`` by the scaled Newton
    iteration, stopped when ||X_k+1 - X_k||_F / ||X_k+1||_F <= 10 eps or
    after ``max_iters``.  Returns (Q, H or None, PolarInfo)."""
    if a.shape[-2] != a.shape[-1]:
        raise ValueError(f"scaled Newton requires a square matrix; got "
                         f"shape {tuple(a.shape)}")
    dtype = a.dtype
    dev = a.device
    eps = eps or torch.finfo(dtype).eps
    tol = 10 * eps
    x = a / _norms.frobenius(a).to(dtype)
    k = 0
    res = torch.ones((), dtype=dtype, device=dev)
    while k < max_iters and float(res) > tol:  # NaN stops, unconverged
        xinv_t = _linalg.inv(x).mT
        # (1, inf)-norm scaling: zeta = (|X^-1|_1 |X^-1|_inf
        #                                / (|X|_1 |X|_inf))^(1/4)
        zeta = ((_norm1(xinv_t) * _norminf(xinv_t))
                / (_norm1(x) * _norminf(x))) ** 0.25
        zeta = zeta.to(dtype)
        x_new = 0.5 * (zeta * x + xinv_t / zeta)
        res = _norms.frobenius(x_new - x) / _norms.frobenius(x_new)
        x, k = x_new, k + 1
    f32 = torch.float32
    info = PolarInfo(
        iterations=torch.tensor(k, dtype=torch.int32, device=dev),
        residual=res, l_final=torch.ones((), dtype=f32, device=dev),
        converged=res <= tol,
        l_init=torch.full((), float("nan"), dtype=f32, device=dev))
    if want_h:
        return x, form_h(x, a), info
    return x, None, info
