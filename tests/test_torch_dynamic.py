"""The port's dynamic Zolo-PD slice against repro.core, on the CPU.

Same inputs (numpy, ``tests/conftest.make_matrix``) through both
packages: the elliptic functions and the run-time Zolotarev coefficients
(``core/elliptic.py``, ``coeffs.zolo_coeffs``/``zolo_l_update``), the
QR-based sigma_min bound, the dynamic engine ``zolo_pd`` and its plan
resolution.

Tolerances, each with its reason:

* coefficients in f64: 1e-13 relative where the Landen recursion is well
  conditioned (l >= 1e-2, where the reference itself is within 2e-13 of
  the exact scipy/mpmath coefficients).  Below that the recursion
  amplifies the 1-2 ulp differences between torch's and XLA's sin/asin
  (both accurate), so the two packages are held to the spread that the
  reference's own error against the exact coefficients allows (2r + 1
  times its error in c, doubled), for l down to 1e-12 (ROADMAP Queue C
  records l < 1e-12);
* coefficients in f32: they stay f32, and agree with the reference's
  within 16 eps(f32) or the same error-spread bound, whichever is
  larger, for l >= 1e-4 (below it the f32 recursion keeps no three
  correct digits in either package);
* sigma_min_lower_qr: 10 kappa eps(dtype) relative (the QR's backward
  error moves sigma_min by up to kappa eps relative);
* zolo_pd: iterations and converged equal; Q within max(1e-12, twice the
  reference's own error against the exact polar factor), the bound of
  tests/test_torch_zolo.py.
* zolo_pd in f32 (the card's dynamic path: f32 run-time bound and
  in-graph coefficients, CholeskyQR2 first): iterations and converged
  equal; l_init within the sigma_min bound above (10 kappa eps(f32));
  the last residual within 1e-3 relative plus 4 eps(f32) (a difference
  of iterates that agree to ~1e-6, or rounding noise at the engine's own
  4 eps floor); Q within max(16 eps(f32), twice the reference's own
  error against the exact polar factor).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
import repro.solver as JS  # noqa: E402
from repro.core import coeffs as jcoeffs  # noqa: E402
from repro.core import elliptic as jelliptic  # noqa: E402
from repro.core import norms as jnorms  # noqa: E402
from repro.core import zolo as jzolo  # noqa: E402
from repro.core import zolo_pallas as jzolo_pallas  # noqa: E402
import repro_torch.solver as S  # noqa: E402
from repro_torch.core import coeffs, elliptic, norms, registry  # noqa: E402
from repro_torch.core import zolo, zolo_cuda  # noqa: E402


def _rel(x, y):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(x - y) / np.abs(y)))


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))


def _exact_polar(a):
    u, _, vt = np.linalg.svd(a, full_matrices=False)
    return u @ vt


# --- elliptic functions and run-time coefficients ---------------------------


@pytest.mark.parametrize("l", [1e-16, 1e-8, 1e-4, 0.3, 0.9])
def test_elliptic_matches_reference(l):
    mc = l * l
    assert _rel(elliptic.ellipk_mc(torch.tensor(mc, dtype=torch.float64)),
                jelliptic.ellipk_mc(jnp.float64(mc))) <= 1e-14
    assert _rel(elliptic.kprime(l), jelliptic.kprime(l)) <= 1e-14
    assert _rel(elliptic.ellipk(0.25), jelliptic.ellipk(0.25)) <= 1e-14
    kp = float(jelliptic.kprime(l))
    u = np.linspace(0.05, 0.6, 5) * kp  # where sn/cn are well conditioned
    got = elliptic.ellipj_mc(torch.from_numpy(u), mc)
    want = jelliptic.ellipj_mc(jnp.asarray(u), jnp.float64(mc))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert _max_err(g.numpy(), w) <= 1e-13


def _coeff_tol(r, c_ref, c_exact, floor, conditioned):
    """``floor`` where the recursion is well conditioned.  Elsewhere, the
    spread the reference's own error allows: a, mhat and the l update are
    products of at most 2r + 1 factors in the c's, so their relative
    error is up to 2r + 1 times that of c; doubled for two packages."""
    if conditioned:
        return floor
    return max(floor, 2.0 * (2 * r + 1) * _rel(c_ref, c_exact))


@functools.lru_cache(maxsize=None)
def _jit_coeffs(r):
    return jax.jit(lambda l: jcoeffs.zolo_coeffs(l, r))


def _check_coeffs(r, l, lt, jl, floor, conditioned):
    c, a, mhat = coeffs.zolo_coeffs(lt, r)
    assert c.shape == (2 * r,) and a.shape == (r,) and mhat.ndim == 0
    cj, aj, mj = _jit_coeffs(r)(jl)
    exact = coeffs.zolo_coeffs_np(l, r)
    tol = _coeff_tol(r, cj, exact[0], floor, conditioned)
    got = (c, a, mhat, coeffs.zolo_l_update(lt, c, mhat))
    want = (cj, aj, mj, jcoeffs.zolo_l_update(jl, cj, mj))
    for g, w in zip(got, want):
        assert g.dtype == lt.dtype
        assert _rel(g.numpy(), w) <= tol, (l, r)


@pytest.mark.parametrize("r", range(1, 9))
def test_zolo_coeffs_f64_match_reference(r):
    for l in np.geomspace(1e-12, 0.9, 13):
        _check_coeffs(r, float(l), torch.tensor(l, dtype=torch.float64),
                      jnp.float64(l), 1e-13, l >= 1e-2)


@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_zolo_coeffs_f32_stay_f32_and_match_reference(r):
    floor = 16.0 * float(np.finfo(np.float32).eps)
    for l in np.geomspace(1e-4, 0.9, 7):
        l32 = float(np.float32(l))
        _check_coeffs(r, l32, torch.tensor(l32), jnp.float32(l32), floor,
                      False)


# --- the QR-based sigma_min bound -------------------------------------------


@pytest.mark.parametrize("kappa", [1e2, 1e6, 1e10])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sigma_min_lower_qr_matches_reference(kappa, dtype):
    a = np.asarray(make_matrix(64, 40, kappa, seed=3), dtype)
    got = norms.sigma_min_lower_qr(torch.from_numpy(a.copy()))
    want = float(jnorms.sigma_min_lower_qr(jnp.asarray(a)))
    assert got.dtype == getattr(torch, dtype)
    eps = float(np.finfo(dtype).eps)
    assert abs(float(got) - want) <= 10.0 * kappa * eps * want


def test_sigma_min_lower_qr_promotes_bf16_and_floors_singular():
    a = np.asarray(make_matrix(48, 32, 1e2, seed=4), np.float32)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    got = norms.sigma_min_lower_qr(ab)
    assert got.dtype == torch.float32
    want = jnorms.sigma_min_lower_qr(
        jnp.asarray(ab.float().numpy()).astype(jnp.bfloat16))
    assert abs(float(got) - float(want)) <= 10.0 * 1e2 * 2 ** -23 * \
        float(want)
    # an exactly singular input gives the 4 eps floor, not NaN
    s = np.array(make_matrix(48, 32, 1e2, seed=5))
    s[:, 3] = 0.0
    got = norms.sigma_min_lower_qr(torch.from_numpy(s))
    want = jnorms.sigma_min_lower_qr(jnp.asarray(s))
    assert float(got) == float(want) == 4 * np.finfo(np.float64).eps
    z = norms.sigma_min_lower_qr(torch.zeros((8, 4)))
    assert float(z) == 4 * np.finfo(np.float32).eps


# --- the dynamic engine ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jit_zolo_pd(first_mode):
    # one compiled reference per first mode, shared by shapes and kappas
    return jax.jit(functools.partial(jzolo.zolo_pd, r=3,
                                     first_mode=first_mode))


@pytest.mark.parametrize("first_mode", ["auto", "cholqr2", "chol"])
@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e6])
@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_zolo_pd_matches_reference(m, n, kappa, first_mode):
    a = np.asarray(make_matrix(m, n, kappa))
    q_j, h_j, info_j = _jit_zolo_pd(first_mode)(jnp.asarray(a))
    q_t, h_t, info_t = zolo.zolo_pd(torch.from_numpy(a.copy()), r=3,
                                    first_mode=first_mode)
    assert q_t.dtype == torch.float64
    assert int(info_t.iterations) == int(info_j.iterations)
    assert bool(info_t.converged) == bool(info_j.converged)
    assert float(info_t.l_init) == pytest.approx(float(info_j.l_init),
                                                 rel=1e-6)
    ref_err = _max_err(q_j, _exact_polar(a))
    assert _max_err(q_t.numpy(), q_j) <= max(1e-12, 2.0 * ref_err)
    # H from the unscaled input: A = Q H
    np.testing.assert_allclose((q_t @ h_t).numpy(), a, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _jit_f32_reference(backend):
    # each port backend's counterpart: zolo_pallas_dynamic for the kernel
    # bundle (Pallas ops as the JAX package runs them off-TPU)
    fn = {"zolo": jzolo.zolo_pd,
          "zolo_cuda_dynamic": jzolo_pallas.zolo_pd_pallas_dynamic}[backend]
    return jax.jit(functools.partial(fn, r=3, first_mode="cholqr2",
                                     want_h=False))


@pytest.mark.parametrize("backend", ["zolo", "zolo_cuda_dynamic"])
@pytest.mark.parametrize("kappa", [1e2, 1e3])
@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_zolo_pd_f32_matches_reference(m, n, kappa, backend):
    a = np.asarray(make_matrix(m, n, kappa), np.float32)
    q_j, _, info_j = _jit_f32_reference(backend)(jnp.asarray(a))
    fn = {"zolo": zolo.zolo_pd,
          "zolo_cuda_dynamic": zolo_cuda.zolo_pd_cuda_dynamic}[backend]
    q_t, _, info_t = fn(torch.from_numpy(a.copy()), r=3, want_h=False,
                        first_mode="cholqr2")
    eps = float(np.finfo(np.float32).eps)
    assert q_t.dtype == info_t.l_init.dtype == torch.float32
    assert int(info_t.iterations) == int(info_j.iterations)
    assert bool(info_t.converged) == bool(info_j.converged) is True
    assert abs(float(info_t.l_init) - float(info_j.l_init)) <= \
        10.0 * kappa * eps * float(info_j.l_init)
    assert abs(float(info_t.residual) - float(info_j.residual)) <= \
        1e-3 * float(info_j.residual) + 4.0 * eps
    ref_err = _max_err(q_j, _exact_polar(a.astype(np.float64)))
    assert _max_err(q_t.numpy(), q_j) <= max(16.0 * eps, 2.0 * ref_err)


def test_zolo_pd_given_l_and_max_iters_match_reference():
    a = np.asarray(make_matrix(40, 24, 1e3, seed=2))
    for kw in ({"l": 0.9e-3}, {"max_iters": 1}):
        q_j, _, info_j = jzolo.zolo_pd(jnp.asarray(a), r=2, want_h=False,
                                       **kw)
        q_t, h_t, info_t = zolo.zolo_pd(torch.from_numpy(a.copy()), r=2,
                                        want_h=False, **kw)
        assert h_t is None
        assert int(info_t.iterations) == int(info_j.iterations)
        assert bool(info_t.converged) == bool(info_j.converged)
        assert _max_err(q_t.numpy(), q_j) <= 1e-12
    assert not bool(info_t.converged)  # one iteration is not enough


def test_householder_regime_raises_and_allow_householder_false_runs():
    # kappa 1e10: the runtime bound (~5e-11) is below 10 sqrt(eps); the
    # structured Householder first iteration is ported, so "auto" and an
    # explicit "householder" run it (test_auto_lands_on_householder_...)
    a = torch.from_numpy(np.array(make_matrix(40, 24, 1e10, seed=1)))
    for mode in ("auto", "householder"):
        q, _, info = zolo.zolo_pd(a, r=3, first_mode=mode, want_h=False)
        assert torch.isfinite(q).all() and bool(info.converged)
    with pytest.raises(ValueError, match="first_mode"):
        zolo.zolo_pd(a, r=3, first_mode="qr")
    # allow_householder=False is the reference's cholqr2 substitute
    x0 = a / norms.sigma_max_upper(a)
    l0 = norms.sigma_min_lower_qr(x0)
    eps = float(np.finfo(np.float64).eps)
    got = zolo.run_dynamic(x0, l0, 3, eps=eps, allow_householder=False)
    jx0 = jnp.asarray(x0.numpy())
    want = jzolo.run_dynamic(jx0, jnp.asarray(float(l0)), 3, eps=eps,
                             allow_householder=False)
    assert got[2] == int(want[2])
    assert bool(got[4]) == bool(want[4])
    # at kappa 1e10 the f64 CholeskyQR2 substitute goes NaN in both
    # packages (the static engine's Queue C fault): the same outcome
    np.testing.assert_array_equal(np.isnan(got[0].numpy()),
                                  np.isnan(np.asarray(want[0])))
    assert np.nanmax(np.abs(got[0].numpy() - np.asarray(want[0])),
                     initial=0.0) <= 1e-10


def test_cuda_dynamic_on_cpu_matches_plain_dynamic():
    # on CPU tensors the kernel bundle runs the plain versions, in f32
    a = torch.from_numpy(np.asarray(make_matrix(130, 70, 1e2, seed=6),
                                    np.float32))
    q_d, _, info_d = zolo.zolo_pd(a, r=2, want_h=False,
                                  first_mode="cholqr2")
    q_k, _, info_k = zolo_cuda.zolo_pd_cuda_dynamic(a, r=2, want_h=False,
                                                    first_mode="cholqr2")
    assert q_k.dtype == torch.float32 and info_k.l_init.dtype == torch.float32
    assert int(info_k.iterations) == int(info_d.iterations)
    assert _max_err(q_k.numpy(), q_d.numpy()) <= 5e-6


# --- plans -----------------------------------------------------------------


def test_runtime_plan_resolves_like_the_reference():
    # tests/test_solver.py::test_auto_mode_runtime_l0_picks_dynamic
    cfg = S.SvdConfig(l0_policy="runtime")
    p = S.plan(cfg, (64, 48), torch.float64, device="cpu")
    jp = JS.plan(JS.SvdConfig(l0_policy="runtime"), (64, 48), jnp.float64)
    assert p.mode == jp.mode == "dynamic"
    assert registry.get_polar(p.method).dynamic
    a = np.asarray(make_matrix(64, 48, 1e3, seed=6))
    u, s, vh = p.svd(torch.from_numpy(a.copy()))
    np.testing.assert_allclose(s.numpy(),
                               np.linalg.svd(a, compute_uv=False),
                               atol=1e-11)
    _, s_j, _ = jp.svd(jnp.asarray(a))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-12)


def test_dynamic_plans_bind_knobs_and_skip_the_prescale():
    cfg = S.SvdConfig(method="zolo_cuda_dynamic", mode="dynamic",
                      l0_policy="runtime", r=4, qr_mode="cholqr2")
    p = S.plan(cfg, (48, 32), torch.float32, device="cpu")
    assert p.method == "zolo_cuda_dynamic" and p.mode == "dynamic"
    assert p._backend_kwargs == {"r": 4, "first_mode": "cholqr2"}
    spec = registry.get_polar("zolo_cuda_dynamic")
    assert spec.dynamic and spec.fallback == "zolo"
    a = 7.0 * torch.from_numpy(
        np.asarray(make_matrix(48, 32, 1e2, seed=7), np.float32))
    q, h, info = p.polar(a)  # no prescale: the backend scales itself
    torch.testing.assert_close(q @ h, a, rtol=0, atol=1e-4)
    assert bool(info.converged)
    p_given = S.plan(S.SvdConfig(method="zolo", l0=0.009, max_iters=5),
                     (48, 32), torch.float64, device="cpu")
    assert p_given.mode == "dynamic"
    assert p_given._backend_kwargs == {
        "r": coeffs.choose_r(1 / 0.009), "l": 0.009, "max_iters": 5}
    with pytest.raises(ValueError, match="qr_iters"):
        S.plan(S.SvdConfig(method="zolo", qr_iters=2), (8, 8),
               torch.float64, device="cpu")
    with pytest.raises(ValueError, match="zolo_static"):
        S.plan(cfg, (48, 32), torch.float64, device="cpu")  # f64 refused
    with pytest.raises(ValueError, match="dynamic"):
        S.plan(S.SvdConfig(method="zolo_static", l0_policy="runtime"),
               (8, 8), torch.float64, device="cpu")
    with pytest.raises(ValueError, match="mode='static'"):
        S.plan(S.SvdConfig(method="zolo", mode="static"), (8, 8),
               torch.float64, device="cpu")
    with pytest.raises(ValueError, match="mode='dynamic'"):
        S.plan(S.SvdConfig(method="zolo_static", mode="dynamic", l0=0.1),
               (8, 8), torch.float64, device="cpu")


def test_svd_info_is_svd_with_its_polar_info():
    p = S.plan(S.SvdConfig(method="zolo_cuda_dynamic", l0_policy="runtime",
                           r=4, qr_mode="cholqr2"),
               (48, 32), torch.float32, device="cpu")
    a = torch.from_numpy(np.asarray(make_matrix(48, 32, 1e2, seed=9),
                                    np.float32))
    u, s, vh, info = p.svd_info(a)
    for got, want in zip((u, s, vh), p.svd(a)):
        assert torch.equal(got, want)
    _, _, info_p = p.polar(a)
    assert int(info.iterations) == int(info_p.iterations)
    assert bool(info.converged)
    with pytest.raises(ValueError, match="shape"):
        p.svd_info(a[:40])


def test_auto_first_mode_in_the_householder_regime_raises_from_a_plan():
    # f32 runtime bound of a kappa-1e4 matrix sits below 10 sqrt(eps(f32)):
    # the default dynamic plan (no qr_mode) takes the Householder first
    # iteration, and agrees with the cholqr2-first plan
    p = S.plan(S.SvdConfig(method="zolo_cuda_dynamic", l0_policy="runtime",
                           r=4), (64, 48), torch.float32, device="cpu")
    a = torch.from_numpy(np.asarray(make_matrix(64, 48, 1e4, seed=8),
                                    np.float32))
    u, s, vh, info = p.svd_info(a)
    assert bool(info.converged)
    assert float(info.l_init) < 10.0 * float(np.finfo(np.float32).eps) ** 0.5
    s_exact = np.linalg.svd(a.double().numpy(), compute_uv=False)
    assert _max_err(s.numpy(), s_exact) <= 1e-5
    _, s_qr2, _, info_qr2 = S.plan(
        S.SvdConfig(method="zolo_cuda_dynamic", l0_policy="runtime", r=4,
                    qr_mode="cholqr2"),
        (64, 48), torch.float32, device="cpu").svd_info(a)
    assert bool(info_qr2.converged)
    assert _max_err(s.numpy(), s_qr2.numpy()) <= 1e-5


@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_auto_lands_on_householder_below_ten_sqrt_eps(m, n, monkeypatch):
    # f64, kappa 1e10: l0 ~ 5e-11 < 10 sqrt(eps) = 1.5e-7.  The "auto"
    # first iteration is the structured Householder one (counted), and
    # iterations, converged and Q match the reference's
    a = np.asarray(make_matrix(m, n, 1e10))
    calls = []
    real = zolo.term_sum_householder
    monkeypatch.setattr(zolo, "term_sum_householder",
                        lambda *a_, **k: calls.append(1) or real(*a_, **k))
    q_t, _, info_t = zolo.zolo_pd(torch.from_numpy(a.copy()), r=3,
                                  want_h=False)
    assert len(calls) == 1
    assert float(info_t.l_init) < 10.0 * np.finfo(np.float64).eps ** 0.5
    q_j, _, info_j = _jit_zolo_pd("auto")(jnp.asarray(a))
    assert int(info_t.iterations) == int(info_j.iterations)
    assert bool(info_t.converged) == bool(info_j.converged) is True
    ref_err = _max_err(q_j, _exact_polar(a))
    assert _max_err(q_t.numpy(), q_j) <= max(1e-12, 2.0 * ref_err)
    # allow_householder=False keeps its meaning: the cholqr2 substitute
    calls.clear()
    x0 = torch.from_numpy(a.copy()) / norms.sigma_max_upper(
        torch.from_numpy(a.copy()))
    zolo.run_dynamic(x0, info_t.l_init.double(), 3,
                     eps=float(np.finfo(np.float64).eps),
                     allow_householder=False)
    assert not calls
