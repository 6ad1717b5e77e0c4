"""Jacobi elliptic functions and complete elliptic integrals in torch.

Port of ``repro/core/elliptic.py``.  The Zolotarev coefficients (paper
eq. 7) need

    K' = K(m = 1 - l^2)            (complete elliptic integral)
    sn(u; l'), cn(u; l')           (Jacobi elliptic functions, modulus l')

For ill-conditioned problems ``l`` is tiny, so ``m = 1 - l^2`` suffers
catastrophic cancellation: every entry point takes the *complementary*
parameter ``mc = l^2`` and never forms ``1 - l^2``.

AGM for K (12 quadratically convergent levels) and the descending
Gauss/Landen transformation for sn/cn/dn, as fixed-length loops of
tensor ops in the dtype of the input: the in-graph coefficients of an f32
solve are computed in f32, as the reference computes them.  A python
number is taken as float64.
"""

from __future__ import annotations

import math

import torch

# AGM / Landen levels: ~1e-16 for mc >= 1e-32 (kappa up to 1e16)
_AGM_LEVELS = 12


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float64)


def _agm_sequence(mc):
    """AGM sequence for modulus k' = sqrt(mc): (a_list, c_list) with a_n
    the arithmetic means and c_n = (a_{n-1} - b_{n-1}) / 2
    (c_0 = k = sqrt(1 - mc))."""
    mc = _as_tensor(mc)
    one = torch.ones_like(mc)
    a = one
    b = torch.sqrt(mc)
    c = torch.sqrt(torch.clamp(one - mc, min=0.0))
    a_hist = [a]
    c_hist = [c]
    for _ in range(_AGM_LEVELS):
        a_next = 0.5 * (a + b)
        c_next = 0.5 * (a - b)
        b = torch.sqrt(torch.clamp(a * b, min=0.0))
        a = a_next
        a_hist.append(a)
        c_hist.append(c_next)
    return a_hist, c_hist


def ellipk_mc(mc):
    """K(m) with m = 1 - mc, from the complementary parameter mc; K' of
    modulus l is ``ellipk_mc(l**2)``."""
    a_hist, _ = _agm_sequence(mc)
    return math.pi / (2.0 * a_hist[-1])


def ellipj_mc(u, mc):
    """Jacobi sn(u|m), cn(u|m), dn(u|m) with m = 1 - mc, by the
    descending Landen/Gauss transformation (mc in (0, 1])."""
    u = _as_tensor(u)
    mc = _as_tensor(mc)
    a_hist, c_hist = _agm_sequence(mc)
    n = _AGM_LEVELS
    phi = (2.0 ** n) * a_hist[n] * u
    for i in range(n, 0, -1):
        t = (c_hist[i] / a_hist[i]) * torch.sin(phi)
        t = torch.clamp(t, -1.0, 1.0)
        phi = 0.5 * (phi + torch.asin(t))
    sn = torch.sin(phi)
    cn = torch.cos(phi)
    m = 1.0 - mc
    dn = torch.sqrt(torch.clamp(1.0 - m * sn * sn, min=0.0))
    return sn, cn, dn


def ellipk(m):
    """K(m) from the parameter m (prefer :func:`ellipk_mc`)."""
    return ellipk_mc(1.0 - _as_tensor(m))


def kprime(l):
    """K'(l) = K(1 - l^2), the complete integral of the complementary
    modulus, as used in the Zolotarev coefficients."""
    l = _as_tensor(l)
    return ellipk_mc(l * l)
