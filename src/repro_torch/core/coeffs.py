"""Zolotarev coefficients (paper §2.1-§2.2).

Port of ``repro/core/coeffs.py``, both halves:

* ``zolo_coeffs`` / ``zolo_l_update`` — torch, on tensors: coefficients
  computed at run time from a lower bound ``l`` on the device (the
  dynamic engine's in-graph coefficients), in ``l``'s dtype, through
  :mod:`repro_torch.core.elliptic`.
* ``zolo_coeffs_np`` ... ``zolo_schedule_np`` — float64 numpy/scipy, the
  same operations in the same order as the reference, so static
  schedules equal the reference's bit for bit.

The QDWH coefficients have the same two halves: ``qdwh_coeffs`` /
``qdwh_l_update`` in torch (``jnp.cbrt`` becomes ``torch.pow(., 1/3)`` of
a non-negative argument) and ``qdwh_coeffs_np`` ... ``qdwh_iter_count``
in numpy, as the reference computes them.

Notation follows the paper: for order ``r`` and lower bound ``l``,

    c_i  = l^2 sn^2(i K'/(2r+1); l') / cn^2(...)      i = 1..2r   (eq. 7)
    Mhat = prod_j (1 + c_{2j-1}) / (1 + c_{2j})                    (eq. 8)
    a_j  = -prod_k (c_{2j-1} - c_{2k}) / prod_{k!=j} (c_{2j-1} - c_{2k-1})
                                                                   (eq. 10)
    l_next = Mhat * l * prod_j (l^2 + c_{2j}) / (l^2 + c_{2j-1})
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from scipy import special as _scipy_special

from repro_torch.core import elliptic

EPS64 = 1.1e-16
MAX_R = 8


# ---------------------------------------------------------------------------
# torch backend (run-time coefficients)
# ---------------------------------------------------------------------------


def zolo_coeffs(l, r: int):
    """Zolotarev coefficients for order ``r`` and lower bound ``l`` (a
    tensor, or a python number taken as float64), in ``l``'s dtype and on
    its device.

    Returns ``(c, a, mhat)``: ``c`` (2r,) (``c[i-1]`` is the paper's
    ``c_i``), ``a`` (r,) and a 0-dim ``mhat``."""
    l = elliptic._as_tensor(l)
    mc = l * l
    kp = elliptic.ellipk_mc(mc)
    i = torch.arange(1, 2 * r + 1, dtype=l.dtype, device=l.device)
    u = i * kp / (2 * r + 1)
    sn, cn, _ = elliptic.ellipj_mc(u, mc)
    c = mc * (sn * sn) / (cn * cn)

    c_even = c[1::2]  # c_{2j},   j = 1..r
    c_odd = c[0::2]   # c_{2j-1}, j = 1..r
    mhat = torch.prod((1.0 + c_odd) / (1.0 + c_even))

    # a_j by the residue formula; the k == j factor of the denominator
    # product is masked to 1
    diff_even = c_odd[:, None] - c_even[None, :]  # c_{2j-1} - c_{2k}
    diff_odd = c_odd[:, None] - c_odd[None, :]    # c_{2j-1} - c_{2k-1}
    eye = torch.eye(r, dtype=l.dtype, device=l.device)
    a = -torch.prod(diff_even, dim=1) / torch.prod(diff_odd + eye, dim=1)
    return c, a, mhat


def zolo_l_update(l, c, mhat):
    """Map the lower bound through the scaled Zolotarev function."""
    l = elliptic._as_tensor(l)
    c_even = c[1::2]
    c_odd = c[0::2]
    l2 = l * l
    return mhat * l * torch.prod((l2 + c_even) / (l2 + c_odd))


def zolo_fn_scalar(x, c, a, mhat):
    """Evaluate hat-Z_{2r+1}(x; l) in partial-fraction form (eq. 9/11)."""
    x = elliptic._as_tensor(x)
    c_odd = c[0::2]
    terms = a / (x[..., None] ** 2 + c_odd)
    return mhat * x * (1.0 + torch.sum(terms, dim=-1))


def zolo_fn_product(x, c, mhat):
    """Evaluate hat-Z_{2r+1}(x; l) in product form (eq. 8) — test oracle."""
    x = elliptic._as_tensor(x)
    c_even = c[1::2]
    c_odd = c[0::2]
    num = x[..., None] ** 2 + c_even
    den = x[..., None] ** 2 + c_odd
    return mhat * x * torch.prod(num / den, dim=-1)


# ---------------------------------------------------------------------------
# numpy/scipy backend (static schedules)
# ---------------------------------------------------------------------------


def _ellipj_mc_np(u, mc):
    if mc > 1e-14:
        sn, cn, dn, _ = _scipy_special.ellipj(np.asarray(u), 1.0 - mc)
        return sn, cn, dn
    # Extreme regime (kappa > 1e7): f64 Landen loses ~8 digits, so the
    # reference uses arbitrary precision; its f64 AGM fallback lives in
    # the JAX package, so the port requires mpmath here instead.
    try:
        import mpmath
    except ImportError as e:
        raise ImportError(
            "Zolotarev coefficients at l^2 <= 1e-14 (kappa > 1e7) need "
            "mpmath; install it") from e
    with mpmath.workdps(40):
        m = mpmath.mpf(1) - mpmath.mpf(float(mc))
        sn = np.array([float(mpmath.ellipfun("sn", float(x), m=m))
                       for x in np.atleast_1d(u)])
        cn = np.array([float(mpmath.ellipfun("cn", float(x), m=m))
                       for x in np.atleast_1d(u)])
        dn = np.array([float(mpmath.ellipfun("dn", float(x), m=m))
                       for x in np.atleast_1d(u)])
    return sn, cn, dn


def _ellipk_mc_np(mc):
    return float(_scipy_special.ellipkm1(mc))


def zolo_coeffs_np(l: float, r: int):
    """Zolotarev coefficients ``(c, a, mhat)`` for order ``r`` and lower
    bound ``l``, in float64: ``c`` (2r,), ``a`` (r,), scalar ``mhat``."""
    l = float(l)
    mc = l * l
    kp = _ellipk_mc_np(mc)
    i = np.arange(1, 2 * r + 1, dtype=np.float64)
    u = i * kp / (2 * r + 1)
    sn, cn, _ = _ellipj_mc_np(u, mc)
    c = mc * sn**2 / cn**2
    c_even = c[1::2]
    c_odd = c[0::2]
    mhat = float(np.prod((1.0 + c_odd) / (1.0 + c_even)))
    a = np.empty(r, dtype=np.float64)
    for j in range(r):
        num = np.prod(c_odd[j] - c_even)
        den = np.prod(np.delete(c_odd[j] - c_odd, j))
        a[j] = -num / den
    return c, a, mhat


def zolo_l_update_np(l: float, c: np.ndarray, mhat: float) -> float:
    """Map the lower bound through the scaled Zolotarev function."""
    c_even = c[1::2]
    c_odd = c[0::2]
    l2 = l * l
    return float(mhat * l * np.prod((l2 + c_even) / (l2 + c_odd)))


@dataclasses.dataclass(frozen=True)
class ZoloIteration:
    """Static coefficients for one Zolo-PD iteration."""

    c: tuple  # (2r,)
    a: tuple  # (r,)
    mhat: float
    l_before: float
    l_after: float

    @property
    def r(self) -> int:
        return len(self.a)


def zolo_schedule_np(l0: float, r: int, max_iters: int = 8,
                     tol: float = 1.0 - 1e-15) -> list[ZoloIteration]:
    """Static per-iteration coefficient schedule until 1 - l <= 1 - tol."""
    sched = []
    l = float(l0)
    for _ in range(max_iters):
        c, a, mhat = zolo_coeffs_np(l, r)
        l_next = zolo_l_update_np(l, c, mhat)
        sched.append(ZoloIteration(tuple(c), tuple(a), mhat, l, l_next))
        l = l_next
        if l >= tol:
            break
    return sched


@functools.lru_cache(maxsize=None)
def zolo_iter_count(kappa: float, r: int, tol: float = 1e-15,
                    max_iters: int = 64) -> int:
    """Smallest k with hat-Z^k([1/kappa, 1]) inside [1 - tol, 1] (the
    paper's Table 1, from the scalar recursion on the lower bound)."""
    l = 1.0 / float(kappa)
    for k in range(1, max_iters + 1):
        c, _, mhat = zolo_coeffs_np(l, r)
        l = zolo_l_update_np(l, c, mhat)
        if 1.0 - l <= tol:
            return k
    return max_iters


def choose_r(kappa: float, max_groups: int = 3, tol: float = 1e-15) -> int:
    """Paper §3.2 policy: prefer small r (2 or 3); grow r only when it
    removes an iteration and resources allow (Table 1)."""
    kappa = max(float(kappa), 1.0 + 1e-12)
    best_r, best_iters = 1, zolo_iter_count(kappa, 1, tol)
    for r in range(2, min(max_groups, MAX_R) + 1):
        it = zolo_iter_count(kappa, r, tol)
        if it < best_iters:
            best_r, best_iters = r, it
    return best_r


# ---------------------------------------------------------------------------
# QDWH dynamic coefficients (paper eq. 2/3; Nakatsukasa-Bai-Gygi 2010)
# ---------------------------------------------------------------------------


def qdwh_coeffs(l):
    """Dynamically weighted Halley coefficients (a, b, c) for the bound
    ``l`` (a tensor, or a python number taken as float64), in ``l``'s
    dtype and on its device."""
    l = elliptic._as_tensor(l)
    l2 = l * l
    # cube root of a non-negative number (l <= 1): torch has no cbrt
    d = torch.pow(4.0 * (1.0 - l2) / (l2 * l2), 1.0 / 3.0)
    a = torch.sqrt(1.0 + d) + 0.5 * torch.sqrt(
        8.0 - 4.0 * d + 8.0 * (2.0 - l2) / (l2 * torch.sqrt(1.0 + d)))
    b = (a - 1.0) ** 2 / 4.0
    c = a + b - 1.0
    return a, b, c


def qdwh_l_update(l, a, b, c):
    """Map the lower bound through one QDWH step."""
    l = elliptic._as_tensor(l)
    return l * (a + b * l * l) / (1.0 + c * l * l)


def qdwh_coeffs_np(l: float):
    l2 = l * l
    d = (4.0 * (1.0 - l2) / (l2 * l2)) ** (1.0 / 3.0)
    a = np.sqrt(1.0 + d) + 0.5 * np.sqrt(
        8.0 - 4.0 * d + 8.0 * (2.0 - l2) / (l2 * np.sqrt(1.0 + d))
    )
    b = (a - 1.0) ** 2 / 4.0
    c = a + b - 1.0
    return float(a), float(b), float(c)


def qdwh_schedule_np(l0: float, max_iters: int = 20,
                     tol: float = 1.0 - 1e-15) -> list:
    """Static (a, b, c, l) schedule for QDWH from the initial bound l0."""
    sched = []
    l = float(l0)
    for _ in range(max_iters):
        a, b, c = qdwh_coeffs_np(l)
        sched.append((a, b, c, l))
        l = float(l * (a + b * l * l) / (1.0 + c * l * l))
        if l >= tol:
            break
    return sched


def qdwh_iter_count(kappa: float, tol: float = 1e-15) -> int:
    return len(qdwh_schedule_np(1.0 / float(kappa), tol=1.0 - tol))
