"""SVD via polar decomposition + symmetric eigendecomposition.

Paper Algorithm 2 (Zolo-SVD):

    1.  A = Q_p H          (Zolo-PD)
    2.  H = V diag(w) V^T  (eigh; the ELPA role)
    3.  U = Q_p V,  sigma = w  (descending)

Port of the main-path registrations of ``repro/core/svd.py`` —
``zolo_static``, ``zolo_cuda`` (the counterpart of ``zolo_pallas``), the
``svd`` oracle and ``eigh`` — and of ``svd_residual``/``orthogonality``.
The assembly itself lives in :mod:`repro_torch.solver.planner`.
"""

from __future__ import annotations

import functools
import types
from typing import Optional

import torch

from repro_torch.core import coeffs as _coeffs
from repro_torch.core import eig as _eig
from repro_torch.core import norms as _norms
from repro_torch.core import qdwh as _qdwh
from repro_torch.core import registry as _registry
from repro_torch.core import zolo as _zolo
from repro_torch.core import zolo_cuda as _zolo_cuda
from repro_torch.core.registry import register_eig, register_polar

# --- plan-time cost models (flops_fn) ---------------------------------------


def _gram_shared_iteration_flops(m, n, r, iters) -> float:
    """``repro/dist/grouped.py::grouped_iteration_flops`` at sep = 1 with
    gram_shared=True: per iteration one shared Gram (2 m n^2) plus, per
    term, an n^3/3 Cholesky and two triangular solves (2 m n^2)."""
    gram = 2.0 * m * n * n
    per_term = n ** 3 / 3.0 + 2.0 * m * n * n
    return float(iters * (gram + r * per_term))


def _zolo_flops(m, n, *, r, kappa, grouped=False, dtype=None, sep=1,
                device=None):
    iters = _coeffs.zolo_iter_count(float(kappa), int(r))
    return _gram_shared_iteration_flops(m, n, int(r), iters)


# The conditioning envelope of the f32-accumulating kernels, keyed by
# (input dtype, accumulator dtype).  An ACCURACY CONTRACT COPIED FROM THE
# PALLAS KERNELS (repro/core/svd.py::PALLAS_KAPPA_ENVELOPE, measured there
# at n = 256) and not measured on Hopper: the Hopper kernels share the
# precision contract (f32 products and sums, global shift clamp), so the
# caps are carried unchanged until a sweep on the card replaces them.
CUDA_F32_KAPPA_MAX = 2.0e4
CUDA_BF16_KAPPA_MAX = 1.0e4
CUDA_KAPPA_ENVELOPE = {
    ("float32", "float32"): CUDA_F32_KAPPA_MAX,
    ("bfloat16", "float32"): CUDA_BF16_KAPPA_MAX,
}
_CUDA_ENVELOPE_VIEW = types.SimpleNamespace(
    kappa_envelope=CUDA_KAPPA_ENVELOPE, kappa_max_f32=CUDA_F32_KAPPA_MAX)


def _cuda_kappa_cap(dtype) -> Optional[float]:
    return _registry.envelope_kappa_max(_CUDA_ENVELOPE_VIEW, dtype)


def _zolo_cuda_flops(m, n, *, r, kappa, grouped=False, dtype=None, sep=1,
                     device=None):
    """The engine's flops on a CUDA plan; +inf where ``zolo_cuda`` would
    not run its kernels or would refuse the plan (a CPU device, an f64
    plan, kappa beyond the dtype's envelope), so auto never picks it
    there."""
    if device is None or torch.device(device).type != "cuda":
        return float("inf")
    if dtype is not None and dtype.itemsize > 4:
        return float("inf")
    cap = None if dtype is None else _cuda_kappa_cap(dtype)
    if cap is not None and kappa is not None and float(kappa) > cap:
        return float("inf")
    return _zolo_flops(m, n, r=r, kappa=kappa)


# --- plan-time static-kwarg binding (plan_fn) --------------------------------


def _zolo_static_planfn(res):
    """Precompute the Zolotarev schedule once, at plan time."""
    if res.l0 is None:
        raise ValueError(
            "a static Zolo schedule needs l0: set SvdConfig.l0, or "
            "l0_policy='estimate_at_plan' with a kappa= hint")
    r = res.r if res.r is not None else _coeffs.choose_r(1.0 / res.l0)
    sched = tuple(_coeffs.zolo_schedule_np(
        res.l0, r, max_iters=res.max_iters or 6))
    return {"schedule": sched,
            "qr_mode": res.qr_mode if res.qr_mode is not None
            else "cholqr2",
            "qr_iters": res.qr_iters if res.qr_iters is not None else 1}


def _cuda_planfn(inner):
    """Wrap ``zolo_cuda``'s plan_fn with its precision checks: an f64
    plan raises (the kernels accumulate in f32 — use ``zolo_static``),
    and a sub-f64 plan whose kappa hint exceeds the dtype's
    :data:`CUDA_KAPPA_ENVELOPE` cap raises."""

    @functools.wraps(inner)
    def planfn(res):
        if res.dtype.itemsize > 4:
            raise ValueError(
                f"{res.method!r} runs f32-accumulating kernels; an "
                f"{_registry.dtype_name(res.dtype)} plan would silently "
                f"lose the precision it asked for — plan it with "
                f"'zolo_static'")
        cap = _cuda_kappa_cap(res.dtype)
        if cap is not None and res.kappa is not None \
                and float(res.kappa) > cap:
            raise ValueError(
                f"{res.method!r} planned at kappa={res.kappa:.3g} in "
                f"{_registry.dtype_name(res.dtype)}: beyond the kernels' "
                f"conditioning envelope (kappa <= {cap:.0e}); plan in "
                f"float64 with 'zolo_static' or lower the kappa hint")
        return inner(res)

    return planfn


register_polar("zolo_static", flops_fn=_zolo_flops,
               plan_fn=_zolo_static_planfn,
               description="precomputed-schedule Zolo-PD, plain torch ops")(
    _zolo.zolo_pd_static)
register_polar("zolo_cuda", flops_fn=_zolo_cuda_flops,
               plan_fn=_cuda_planfn(_zolo_static_planfn),
               fallback="zolo_static", kappa_max_f32=CUDA_F32_KAPPA_MAX,
               kappa_envelope=CUDA_KAPPA_ENVELOPE,
               description="precomputed-schedule Zolo-PD on the Hopper "
                           "kernels (fused Gram + r-term combine; plain "
                           "versions on a CPU tensor)")(
    _zolo_cuda.zolo_pd_cuda)


@register_polar("svd", is_oracle=True,
                description="torch.linalg.svd oracle (PDGESVD role)")
def _svd_oracle_polar(a, *, want_h: bool = True, **_):
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    q = u @ vh
    h = (vh.mT * s[..., None, :]) @ vh if want_h else None
    dev = a.device
    info = _qdwh.PolarInfo(
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=a.dtype, device=dev),
        torch.ones((), dtype=torch.float32, device=dev),
        torch.ones((), dtype=torch.bool, device=dev),
        torch.full((), float("nan"), dtype=torch.float32, device=dev))
    return q, h, info


@register_eig("eigh", description="LAPACK/cuSOLVER symmetric eigensolver")
def _eigh_backend(h, **_):
    return _eig.eigh(h)


def svd_residual(a, u, s, vh, *, v0=None):
    """Paper eq. (13): ||A - U diag(s) V^H||_F / ||A||_2 (``v0``: the
    power iteration's start vector, see :func:`norms.sigma_max_power`)."""
    rec = (u * s[..., None, :]) @ vh
    a2 = _norms.sigma_max_power(a, iters=20, v0=v0)
    return _norms.frobenius(a - rec) / a2


def orthogonality(q):
    """||I - Q^H Q||_F / n (paper's OrthL/OrthR)."""
    n = q.shape[-1]
    g = q.mT @ q
    return _norms.frobenius(
        g - torch.eye(n, dtype=q.dtype, device=q.device)) / n
