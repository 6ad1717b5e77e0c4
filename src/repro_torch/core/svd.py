"""SVD via polar decomposition + symmetric eigendecomposition.

Paper Algorithm 2 (Zolo-SVD) and its QDWH-SVD sibling:

    1.  A = Q_p H          (Zolo-PD / QDWH-PD / scaled Newton)
    2.  H = V diag(w) V^T  (eigh or block-Jacobi; the ELPA role)
    3.  U = Q_p V,  sigma = w  (descending)

plus the direct baselines: ``torch.linalg.svd`` (the PDGESVD role) and a
one-sided (Hestenes) block-Jacobi SVD, :func:`jacobi_svd`.

Port of the registrations of ``repro/core/svd.py`` — ``zolo``
(dynamic), ``zolo_static``, ``zolo_cuda`` and ``zolo_cuda_dynamic`` (the
counterparts of ``zolo_pallas`` and ``zolo_pallas_dynamic``), the grouped
(Algorithm 3) ``zolo_grouped`` and ``zolo_grouped_dynamic``, ``qdwh``,
``qdwh_static``, the ``newton`` baseline, the ``svd`` oracle, and the
eigensolvers ``eigh`` and ``jacobi`` — of the one-call wrappers
:func:`polar_decompose` and :func:`polar_svd`, and of
``svd_residual``/``orthogonality``.  The assembly itself lives in
:mod:`repro_torch.solver.planner`.
"""

from __future__ import annotations

import functools
import types
from typing import Optional

import torch

from repro_torch.analysis.plan_audit import wide_ok
from repro_torch.core import coeffs as _coeffs
from repro_torch.core import eig as _eig
from repro_torch.core import newton as _newton
from repro_torch.core import norms as _norms
from repro_torch.core import qdwh as _qdwh
from repro_torch.core import registry as _registry
from repro_torch.core import zolo as _zolo
from repro_torch.core import zolo_cuda as _zolo_cuda
from repro_torch.core.registry import register_eig, register_polar

def _grouped_zolo_adapter(a, *, mesh, l0=None, r=None, want_h: bool = False,
                          hermitian_source=None, schedule=None, **kw):
    """The (q, h, info) contract through Algorithm-3 grouped execution,
    with the kwargs of ``zolo_pd_static`` and a plan-built ``schedule``.
    Imported lazily: core does not depend on repro_torch.dist."""
    from repro_torch.dist import grouped as _grouped

    if l0 is None and schedule is None:
        raise ValueError("grouped zolo execution needs a static l0= or a "
                         "plan-built schedule=")
    q, info = _grouped.grouped_zolo_pd_static(a, mesh=mesh, l0=l0, r=r,
                                              schedule=schedule,
                                              return_info=True, **kw)
    src = a if hermitian_source is None else hermitian_source
    h = _qdwh.form_h(q, src) if want_h else None
    return q, h, info


def _grouped_zolo_dynamic_adapter(a, *, mesh, want_h: bool = False,
                                  hermitian_source=None, **kw):
    """(q, h, info) over the run-time-conditioning Algorithm-3 driver:
    the sigma_min bound is estimated sep-collectively and feeds the
    run-time Zolotarev coefficients."""
    from repro_torch.dist import grouped as _grouped

    q, info = _grouped.grouped_zolo_pd_dynamic(a, mesh=mesh,
                                               return_info=True, **kw)
    src = a if hermitian_source is None else hermitian_source
    h = _qdwh.form_h(q, src) if want_h else None
    return q, h, info


# --- plan-time cost models (flops_fn) ---------------------------------------
# The Zolotarev models are repro_torch.dist.grouped's flop accounting
# (imported lazily: core does not depend on repro_torch.dist at import).


def _zolo_flops(m, n, *, r, kappa, grouped=False, dtype=None, sep=1,
                device=None):
    from repro_torch.dist.grouped import grouped_iteration_flops

    iters = _coeffs.zolo_iter_count(float(kappa), int(r))
    # one address space shares the Gram across the r terms; grouped
    # (Alg. 3) execution recomputes it per group, its work split over sep
    return grouped_iteration_flops(m, n, int(r), iters,
                                   gram_shared=not grouped,
                                   sep=int(sep) if grouped else 1)


def _zolo_grouped_dynamic_flops(m, n, *, r, kappa, grouped=False,
                                dtype=None, sep=1, device=None):
    """The static grouped arithmetic plus what run-time conditioning
    costs: the sep-collective sigma_min estimate (one distributed Gram,
    the replicated n^3/3 Cholesky and ~8 pairs of O(n^2) solves) and one
    safety iteration (the bound's 0.5 factor).  The margin keeps auto on
    the static schedule whenever l0 is known at plan time."""
    from repro_torch.dist.grouped import grouped_iteration_flops

    sep_eff = int(sep) if grouped else 1
    iters = _coeffs.zolo_iter_count(float(kappa), int(r)) + 1
    base = grouped_iteration_flops(m, n, int(r), iters,
                                   gram_shared=not grouped, sep=sep_eff)
    estimate = 2.0 * m * n * n / sep_eff + n ** 3 / 3.0 + 8 * 2.0 * n * n
    # every group pays the estimate (the summed-over-groups basis)
    return base + (int(r) if grouped else 1) * estimate


# The conditioning envelope of the f32-accumulating kernels, keyed by
# (input dtype, accumulator dtype): the largest kappa at which zolo_cuda's
# polar factor met the port's limits, measured by chip_smoke.py phase 15
# on an NVIDIA H100 80GB HBM3 (power limit 700.00 W) at n = 11,999 (the
# linverse singular vectors, geometric spectrum 1..1/kappa, l0 = 1/kappa,
# r = choose_r(kappa) = 2, 3 iterations).  f32: finite, orthogonality and
# ||A - QH||_F/||A||_F <= 1e-4 at every kappa swept, 1e4..1e6 (at 1e6:
# 1.8e-8 and 5.6e-5).  bf16 iterates: finite, orthogonality <= 8 eps(bf16)
# = 0.0625 at every kappa swept, 3e3..1e5 (at 1e5: 1.9e-4).  Each cap is
# the sweep's largest point, not a measured breaking point.  (The copied
# Pallas caps, 2e4 and 1e4 from an n = 256 sweep, were below both.)
CUDA_F32_KAPPA_MAX = 1.0e6
CUDA_BF16_KAPPA_MAX = 1.0e5
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


def _qdwh_flops(m, n, *, r, kappa, grouped=False, dtype=None, sep=1,
                device=None):
    iters = _coeffs.qdwh_iter_count(float(kappa))
    # per iteration: Gram product + n^3/3 Cholesky + two solves (the QR
    # iterations cost more, but only the leading one or two use QR)
    return iters * (2.0 * m * n * n + n ** 3 / 3.0 + 2.0 * m * n * n)


def _newton_flops(m, n, *, r, kappa, grouped=False, dtype=None, sep=1,
                  device=None):
    if m != n:
        return float("inf")  # scaled Newton needs a square nonsingular A
    # explicit LU inverse (~2 n^3) per iteration, ~9 iterations
    return 9.0 * 2.0 * n ** 3


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


def _qdwh_static_planfn(res):
    if res.l0 is None:
        raise ValueError(
            "a static QDWH schedule needs l0: set SvdConfig.l0, or "
            "l0_policy='estimate_at_plan' with a kappa= hint")
    kw = {"schedule": tuple(_coeffs.qdwh_schedule_np(
        res.l0, max_iters=res.max_iters or 8))}
    if res.qr_iters is not None:  # None keeps the c_k > 100 rule
        kw["qr_iters"] = res.qr_iters
    return kw


def _zolo_dynamic_planfn(res):
    """Shared by the dynamic Zolo bindings (``zolo``, ``zolo_cuda_dynamic``,
    ``zolo_grouped_dynamic``): an explicit l0 (or plan-time estimate)
    short-circuits the run-time bound, and the config's ``qr_mode`` knob
    picks the peeled first iteration (the drivers' ``first_mode``).  A
    grouped plan's r is the mesh's."""
    kw = {}
    if res.r is not None:
        kw["r"] = res.r
    if res.l0 is not None:
        kw["l"] = res.l0
    if res.max_iters is not None:
        kw["max_iters"] = res.max_iters
    if res.qr_mode is not None:
        kw["first_mode"] = res.qr_mode
    return kw


def _qdwh_dynamic_planfn(res):
    kw = {}
    if res.l0 is not None:
        kw["l"] = res.l0
    if res.max_iters is not None:
        kw["max_iters"] = res.max_iters
    return kw


def _newton_planfn(res):
    return {"max_iters": res.max_iters} if res.max_iters is not None else {}


def _cuda_planfn(inner):
    """Wrap a kernel binding's plan_fn with its precision checks, keyed on
    the compute dtype (``res.score_dtype``: the config's ``compute_dtype``
    when set, the plan dtype otherwise): an f64 computation raises (the
    kernels accumulate in f32 — use ``zolo_static`` or ``zolo``), and a
    sub-f64 one whose kappa hint exceeds the dtype's
    :data:`CUDA_KAPPA_ENVELOPE` cap raises.  A dynamic plan without a
    kappa or l0 hint passes: its conditioning exists only at run time."""

    @functools.wraps(inner)
    def planfn(res):
        eff = res.score_dtype
        if eff.itemsize > 4:
            raise ValueError(
                f"{res.method!r} runs f32-accumulating kernels; an "
                f"{_registry.dtype_name(eff)} computation would silently "
                f"lose the precision it asked for — plan it with "
                f"'zolo_static' (or 'zolo', dynamic)")
        cap = _cuda_kappa_cap(eff)
        if cap is not None and res.kappa is not None \
                and float(res.kappa) > cap:
            raise ValueError(
                f"{res.method!r} planned at kappa={res.kappa:.3g} in "
                f"{_registry.dtype_name(eff)}: beyond the kernels' "
                f"conditioning envelope (kappa <= {cap:.0e}); plan in "
                f"float64 with 'zolo_static' or lower the kappa hint")
        return inner(res)

    return planfn


register_polar("zolo", dynamic=True, flops_fn=_zolo_flops,
               plan_fn=_zolo_dynamic_planfn,
               description="dynamic Zolo-PD, run-time coefficients, plain "
                           "torch ops")(_zolo.zolo_pd)
register_polar("zolo_static", supports_grouped=True,
               grouped_fn=_grouped_zolo_adapter, flops_fn=_zolo_flops,
               plan_fn=_zolo_static_planfn,
               description="precomputed-schedule Zolo-PD, plain torch ops")(
    _zolo.zolo_pd_static)
register_polar("zolo_grouped", supports_grouped=True, requires_mesh=True,
               grouped_fn=_grouped_zolo_adapter, flops_fn=_zolo_flops,
               plan_fn=_zolo_static_planfn,
               description="paper Alg. 3: one Zolotarev term per group of "
                           "ranks (K1/K2 on a CUDA iterate)")(
    _grouped_zolo_adapter)
register_polar("zolo_grouped_dynamic", dynamic=True, supports_grouped=True,
               requires_mesh=True,
               grouped_fn=_grouped_zolo_dynamic_adapter,
               flops_fn=_zolo_grouped_dynamic_flops,
               plan_fn=_zolo_dynamic_planfn,
               description="paper Alg. 3 with run-time conditioning: a "
                           "sep-collective sigma_min bound feeding run-time "
                           "Zolotarev coefficients")(
    _grouped_zolo_dynamic_adapter)
register_polar("zolo_cuda", flops_fn=_zolo_cuda_flops,
               plan_fn=_cuda_planfn(_zolo_static_planfn),
               fallback="zolo_static", kappa_max_f32=CUDA_F32_KAPPA_MAX,
               kappa_envelope=CUDA_KAPPA_ENVELOPE,
               description="precomputed-schedule Zolo-PD on the Hopper "
                           "kernels (fused Gram + r-term combine; plain "
                           "versions on a CPU tensor)")(
    _zolo_cuda.zolo_pd_cuda)
register_polar("zolo_cuda_dynamic", dynamic=True, flops_fn=_zolo_cuda_flops,
               plan_fn=_cuda_planfn(_zolo_dynamic_planfn), fallback="zolo",
               kappa_max_f32=CUDA_F32_KAPPA_MAX,
               kappa_envelope=CUDA_KAPPA_ENVELOPE,
               description="dynamic Zolo-PD on the Hopper kernels "
                           "(run-time coefficients; K1 and K2 inside the "
                           "residual-stopped loop; plain versions on a CPU "
                           "tensor)")(
    _zolo_cuda.zolo_pd_cuda_dynamic)

register_polar("qdwh", dynamic=True, flops_fn=_qdwh_flops,
               plan_fn=_qdwh_dynamic_planfn,
               description="dynamic QDWH-PD baseline")(_qdwh.qdwh_pd)
register_polar("qdwh_static", flops_fn=_qdwh_flops,
               plan_fn=_qdwh_static_planfn,
               description="precomputed-schedule QDWH-PD")(
    _qdwh.qdwh_pd_static)
# baseline=True: the explicit inverse each iteration makes Newton the
# accuracy/stability baseline, not a production pick — its flop count is
# kappa-insensitive and would otherwise win method="auto" on every square
# problem
register_polar("newton", dynamic=True, baseline=True,
               flops_fn=_newton_flops, plan_fn=_newton_planfn,
               description="scaled Newton PD baseline")(
    _newton.scaled_newton_pd)


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


@register_eig("jacobi", description="padded block-Jacobi (ELPA role)")
def _jacobi_backend(h, *, nb: int = 32, **_):
    return _eig.padded_block_jacobi_eigh(h, nb=nb)


def polar_decompose(a, method: str = "zolo", *, mesh=None, **kw):
    """Polar decomposition in one call.  Returns (q, h, info) with
    A ~= Q H.

    A thin wrapper over the plan path: the call resolves a cached
    :class:`repro_torch.solver.SvdPlan` for (shape, dtype, device,
    config) — the one dispatch route to a registered backend — on
    ``a``'s device, with ``scale="none"`` (the caller pre-scales for a
    static backend, as with the reference's wrapper).  Hold a plan for
    repeated solves (``repro_torch.solver.plan``).

    H (when the backend's ``want_h`` asks for it) is the *right* polar
    factor, square with trailing dim n = a.shape[-1]: for m < n the
    canonical factorization A^T = Q_w H_w is re-oriented as
    H = Q_w H_w Q_w^T, so A = Q H holds in every orientation.

    ``mesh=`` (:func:`repro_torch.dist.zolo_group_mesh`) runs a
    grouped-capable method as Algorithm 3; every rank of the mesh calls
    with the full ``a`` and gets the full result."""
    import repro_torch.solver.planner as _planner

    pl, runtime_kw = _planner.plan_for_call(
        a.shape[-2:], a.dtype, method=method, device=a.device, mesh=mesh,
        kw=kw)
    return pl._polar_impl(a, extra=runtime_kw)


def polar_svd(a, method: str = "zolo", eig_method: str = "eigh",
              nb: int = 32, *, mesh=None, **kw):
    """SVD A = U diag(s) V^H via PD + EIG (paper Alg. 2) in one call.

    Returns (u, s, vh) with s descending — a drop-in for
    ``torch.linalg.svd(a, full_matrices=False)``.  ``mesh=`` routes the
    polar stage through grouped (Algorithm 3) execution.  Like
    :func:`polar_decompose`, a thin wrapper over the plan path."""
    import repro_torch.solver.planner as _planner

    kw.setdefault("want_h", True)
    pl, runtime_kw = _planner.plan_for_call(
        a.shape[-2:], a.dtype, method=method, eig_method=eig_method,
        nb=nb, device=a.device, mesh=mesh, kw=kw)
    return pl._svd_impl(a, extra=runtime_kw)


def jacobi_svd(a, nb: int = 32, max_sweeps: int = _eig.MAX_SWEEPS,
               tol=None):
    """One-sided (Hestenes) block-Jacobi SVD — direct-method baseline.

    Orthogonalizes column blocks pairwise with the eigensolver's
    tournament schedule, sweeping (a host loop) until the normalized
    off-diagonal measure of X^T X is at most ``tol`` (default 30 eps) or
    ``max_sweeps``.  Requires n % nb == 0 and n // nb even.  Returns
    (u, s, vh), s descending.

    Each block rotation — the pair's Gram, its ``eigh`` and the products
    with it — is computed in float64 whatever ``a``'s dtype, and the
    rotated columns are stored back in it.  The reference computes them
    in the input dtype: an f32 Gram squares the block's conditioning, so
    the rotations of its small columns lose their orthogonality (on the
    linverse spectrum, kappa 9.06e3, the reference's U misses the f32
    limit of 1e-4 already at n = 128: tests/test_torch_eig.py).  For f64
    input the arithmetic is the reference's.  The plan audit's
    ``wide_ok("jacobi-svd rotations")`` scope marks them.

    ``max_sweeps`` defaults to the eigensolver's cap,
    :data:`repro_torch.core.eig.MAX_SWEEPS` (40); the reference's 16
    leaves that spectrum unconverged at n = 2,048."""
    if a.ndim != 2:
        raise ValueError(f"jacobi_svd takes one (m, n) matrix; got shape "
                         f"{tuple(a.shape)}")
    m, n = a.shape
    dtype = a.dtype
    if n % nb != 0 or (n // nb) % 2 != 0:
        raise ValueError(
            f"jacobi_svd needs n divisible by nb with an even block "
            f"count; got a.shape={tuple(a.shape)}, nb={nb} "
            f"(n % nb = {n % nb}, n // nb = {n // nb})")
    ids = _eig._pair_columns(n // nb, nb, a.device)
    tol = tol if tol is not None else 30 * torch.finfo(dtype).eps
    hi = torch.float64  # the block rotations' precision (see above)
    tiny = torch.finfo(dtype).tiny

    def off_measure(x):
        g = x.mT @ x
        d = torch.sqrt(torch.clamp(torch.diagonal(g), min=tiny))
        gn = g / torch.outer(d, d)
        return torch.sqrt(torch.sum(torch.tril(gn, -1) ** 2)) / n

    x = a.clone()
    v = torch.eye(n, dtype=dtype, device=a.device)
    sweeps, off = 0, 1.0
    while sweeps < max_sweeps and off > tol:  # NaN stops
        for col_ids in ids:
            flat = col_ids.reshape(-1)
            blocks = x[:, flat].reshape(m, -1, 2 * nb).transpose(0, 1)
            with wide_ok("jacobi-svd rotations"):
                bh = blocks.to(hi)
                _, j = torch.linalg.eigh(bh.mT @ bh)
                # descending eigenvalue order keeps big columns first
                j = torch.flip(j, dims=[-1])
                x[:, flat] = (bh @ j).to(dtype).transpose(0, 1).reshape(
                    m, -1)
                vblocks = v[:, flat].reshape(n, -1, 2 * nb).transpose(0, 1)
                v[:, flat] = (vblocks.to(hi) @ j).to(dtype).transpose(
                    0, 1).reshape(n, -1)
        sweeps += 1
        off = float(off_measure(x))
    s = torch.linalg.vector_norm(x, dim=0)
    order = torch.argsort(-s, stable=True)
    s = s[order]
    u = x[:, order] / torch.clamp(s[None, :], min=tiny)
    vh = v[:, order].mT
    return u, s, vh


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
