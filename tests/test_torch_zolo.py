"""The port's static Zolo-PD engine and norms against repro.core, in f64.

Same inputs (tests/conftest.make_matrix, numpy) through both packages;
the polar factor Q must agree within 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
from repro.core import norms as jnorms  # noqa: E402
from repro.core import zolo as jzolo  # noqa: E402
from repro_torch.core import coeffs, norms, zolo, zolo_cuda  # noqa: E402

TOL = 1e-12


def _both(m, n, kappa, seed=0):
    a = np.asarray(make_matrix(m, n, kappa, seed=seed))
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))


def _exact_polar(a):
    u, _, vt = np.linalg.svd(a, full_matrices=False)
    return u @ vt


@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e6])
@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_zolo_pd_static_cholqr2_matches_reference(m, n, kappa):
    a_t, a_j = _both(m, n, kappa)
    l0 = 0.9 / kappa
    q_j, _, info_j = jzolo.zolo_pd_static(a_j, l0=l0, qr_mode="cholqr2")
    q_t, h_t, info_t = zolo.zolo_pd_static(a_t, l0=l0, qr_mode="cholqr2",
                                           want_h=True)
    assert q_t.dtype == torch.float64
    # Two f64 implementations (XLA's Cholesky/solves vs LAPACK's) agree
    # to within the reference's own error against the exact polar factor:
    # 1e-12 while that error is below it (kappa <= 1e4), twice that
    # error beyond (it grows like kappa * eps: 5e-12 at kappa 1e6).
    ref_err = _max_err(q_j, _exact_polar(a_t.numpy()))
    assert _max_err(q_t.numpy(), q_j) <= max(TOL, 2.0 * ref_err)
    if kappa <= 1e4:
        assert ref_err <= TOL
    assert int(info_t.iterations) == int(info_j.iterations)
    assert float(info_t.l_final) == float(info_j.l_final)
    # A = Q H with H symmetric
    np.testing.assert_allclose((q_t @ h_t).numpy(), a_t.numpy(), atol=1e-12)


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_zolo_pd_static_chol_matches_reference(m, n, r):
    # chol-first only where the reference itself is accurate (kappa 1e2)
    a_t, a_j = _both(m, n, 1e2, seed=1)
    q_j, _, _ = jzolo.zolo_pd_static(a_j, l0=0.9e-2, r=r, qr_mode="chol")
    q_t, _, _ = zolo.zolo_pd_static(a_t, l0=0.9e-2, r=r, qr_mode="chol")
    assert _max_err(q_t.numpy(), q_j) <= TOL


def test_term_sums_match_reference():
    a_t, a_j = _both(40, 24, 1e3, seed=2)
    c = np.array([1e-4, 3e-2, 0.7])
    w = np.array([0.3, -1.2, 2.0])
    ct, wt = torch.from_numpy(c), torch.from_numpy(w)
    assert _max_err(zolo.term_sum_chol(a_t, ct, wt).numpy(),
                    jzolo.term_sum_chol(a_j, jnp.asarray(c),
                                        jnp.asarray(w))) <= 1e-10
    assert _max_err(zolo.term_sum_cholqr2(a_t, ct, wt).numpy(),
                    jzolo.term_sum_cholqr2(a_j, jnp.asarray(c),
                                           jnp.asarray(w))) <= 1e-10


@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_indefinite_shift_gives_nan_not_an_exception(m, n):
    # f64 shifts are never clamped: at kappa 1e10 the first CholeskyQR2
    # shift (c_1 ~ 2e-18) sits below the f64 Gram's rounding noise, so
    # Z = X^T X + c_1 I goes indefinite.  jnp.linalg.cholesky answers NaN
    # (the reference's static cholqr2 path fails here); so must the port.
    a_t, a_j = _both(m, n, 1e10)
    q_j, _, _ = jzolo.zolo_pd_static(a_j, l0=0.9e-10, qr_mode="cholqr2")
    q_t, _, _ = zolo.zolo_pd_static(a_t, l0=0.9e-10, qr_mode="cholqr2")
    assert np.isnan(np.asarray(q_j)).all()
    assert torch.isnan(q_t).all()
    z = torch.stack([torch.eye(3, dtype=torch.float64),
                     torch.diag(torch.tensor([1.0, -1.0, 1.0],
                                             dtype=torch.float64))])
    lz = zolo._cholesky(z)
    assert torch.equal(lz[0], torch.eye(3, dtype=torch.float64))
    assert torch.isnan(lz[1]).all()


def test_first_pass_ridge():
    # sub-f64 only: shifts below sqrt(n) * 8 eps max diag are raised to it
    n = 16
    z = torch.eye(n).expand(2, n, n) * 0.5
    c_eff = torch.tensor([1e-9, 1.0])
    got = zolo._first_pass_ridge(z, c_eff, torch.float32)
    rho = n ** 0.5 * 8.0 * torch.finfo(torch.float32).eps * 0.5
    torch.testing.assert_close(torch.diagonal(got[0]),
                               torch.full((n,), 0.5 + rho - 1e-9))
    assert torch.equal(got[1], z[1])
    z64 = z.double()
    assert zolo._first_pass_ridge(z64, c_eff.double(), torch.float64) is z64


@pytest.mark.parametrize("kappa", [1e4, 2e4])
def test_ridged_first_pass_keeps_the_cholqr2_term(kappa, monkeypatch):
    # inside the f32 envelope, with the ridge active for the smallest
    # shift, the f32 term is as close to the exact (f64) term as the
    # unridged f32 term is: the ridge preconditions, it does not perturb
    from repro_torch.core import coeffs

    a64 = np.asarray(make_matrix(96, 64, kappa, seed=4))
    it = coeffs.zolo_schedule_np(0.9 / kappa, 2)[0]
    c = torch.tensor(it.c[0::2])
    w = torch.tensor(it.a)
    x32 = torch.from_numpy(a64.astype(np.float32))
    g = zolo._gram(x32)
    c_eff = zolo._clamp_shift(c.float(), g, torch.float32)
    ridged = zolo._first_pass_ridge(g.expand(2, 64, 64), c_eff,
                                    torch.float32)
    assert float(torch.diagonal(ridged[0]).sub(torch.diagonal(g)).min()) > 0
    t64 = zolo.term_sum_cholqr2(torch.from_numpy(a64.copy()), c, w)

    def err():
        t32 = zolo.term_sum_cholqr2(x32, c.float(), w.float())
        return float((t32.double() - t64).abs().max() / t64.abs().max())

    with_ridge = err()
    monkeypatch.setattr(zolo, "_first_pass_ridge", lambda z, c, d: z)
    assert with_ridge <= max(2.0 * err(), 1e-5)


def test_iteration_modes_validate():
    a_t, a_j = _both(16, 8, 10.0)
    with pytest.raises(ValueError, match="qr_mode"):
        zolo.zolo_pd_static(a_t, l0=0.09, qr_mode="qr")
    # every mode of the reference runs, householder included
    for mode in zolo.ITER_MODES:
        q_t, _, _ = zolo.zolo_pd_static(a_t, l0=0.09, qr_mode=mode)
        q_j, _, _ = jzolo.zolo_pd_static(a_j, l0=0.09, qr_mode=mode)
        assert _max_err(q_t.numpy(), q_j) <= TOL
    with pytest.raises(ValueError, match="schedule"):
        zolo.zolo_pd_static(a_t)


# --- the structured Householder term ----------------------------------------


def _exact_iteration(a, c, w, mhat):
    """X -> mhat (X + sum_j w_j X (X^T X + c_j I)^{-1}) through the SVD of
    X, in f64: mhat s (1 + sum_j w_j / (s^2 + c_j)) on each singular
    value."""
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    f = mhat * s * (1.0 + sum(wj / (s * s + cj) for cj, wj in zip(c, w)))
    return (u * f) @ vt


@pytest.mark.parametrize("hh_block", [8, 32])
@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e6])
@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_householder_iteration_matches_reference(m, n, kappa, hh_block):
    a_t, a_j = _both(m, n, kappa, seed=3)
    it = coeffs.zolo_schedule_np(0.9 / kappa, 3)[0]
    c, w = np.array(it.c[0::2]), np.array(it.a)
    got = zolo.zolo_iteration(a_t, torch.from_numpy(c), torch.from_numpy(w),
                              torch.tensor(it.mhat, dtype=torch.float64),
                              mode="householder", hh_block=hh_block)
    want = jzolo.zolo_iteration(a_j, jnp.asarray(c), jnp.asarray(w),
                                jnp.float64(it.mhat), mode="householder",
                                hh_block=hh_block)
    assert got.dtype == torch.float64
    # 1e-12 while the reference's own error against the exact iteration
    # is below it (kappa <= 1e4), twice that error beyond, as for Q above
    ref_err = _max_err(want, _exact_iteration(a_t.numpy(), c, w, it.mhat))
    if kappa <= 1e4:
        assert ref_err <= TOL
    assert _max_err(got.numpy(), want) <= max(TOL, 2.0 * ref_err)
    if kappa > 1e2:
        return
    t = zolo.term_sum_householder(a_t, torch.from_numpy(c),
                                  torch.from_numpy(w), block=hh_block)
    t_j = jzolo.term_sum_householder(a_j, jnp.asarray(c), jnp.asarray(w),
                                     block=hh_block)
    assert _max_err(t.numpy(), t_j) <= TOL


@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_householder_static_is_finite_where_cholqr2_is_nan(m, n):
    # kappa 1e10 in f64: the reference's route (the cholqr2 first
    # iteration is all NaN there, test_indefinite_shift_gives_nan_...)
    a_t, a_j = _both(m, n, 1e10)
    q_j, _, info_j = jzolo.zolo_pd_static(a_j, l0=0.9e-10,
                                          qr_mode="householder")
    q_t, h_t, info_t = zolo.zolo_pd_static(a_t, l0=0.9e-10,
                                           qr_mode="householder",
                                           want_h=True)
    assert torch.isfinite(q_t).all()
    assert int(info_t.iterations) == int(info_j.iterations)
    # two f64 solves at kappa 1e10 agree within the reference's own
    # error against the exact polar factor (doubled), as at 1e6 above
    ref_err = _max_err(q_j, _exact_polar(a_t.numpy()))
    assert _max_err(q_t.numpy(), q_j) <= max(TOL, 2.0 * ref_err)
    assert ref_err < 1e-5
    np.testing.assert_allclose((q_t @ h_t).numpy(), a_t.numpy(),
                               atol=1e-12)


def test_cuda_ops_bundle_on_cpu_runs_the_householder_path():
    # the kernel bundle's plain versions on CPU tensors: the Householder
    # iteration's combine goes through ops.polar_update (K2's entry)
    # (kappa 1e4 in f32: l0 below 10 sqrt(eps(f32)), the Householder regime)
    a = torch.from_numpy(np.asarray(make_matrix(130, 70, 1e4, seed=6),
                                    np.float32))
    q_d, _, _ = zolo.zolo_pd_static(a, l0=0.9e-4, r=2,
                                    qr_mode="householder", hh_block=16)
    q_k, _, _ = zolo_cuda.zolo_pd_cuda(a, l0=0.9e-4, r=2,
                                       qr_mode="householder", hh_block=16)
    assert q_k.dtype == torch.float32 and torch.isfinite(q_k).all()
    assert _max_err(q_k.numpy(), q_d.numpy()) <= 5e-6
    assert _max_err(q_k.numpy(), _exact_polar(a.double().numpy())) <= 1e-4


def test_cuda_ops_bundle_on_cpu_matches_default_ops():
    # on CPU tensors the kernel bundle runs the plain versions: the same
    # iteration as the default ops, here in f32 at a ragged shape
    a = torch.from_numpy(np.asarray(make_matrix(130, 70, 1e2, seed=6),
                                    np.float32))
    q_d, _, _ = zolo.zolo_pd_static(a, l0=0.9e-2, r=2)
    q_k, _, _ = zolo_cuda.zolo_pd_cuda(a, l0=0.9e-2, r=2)
    assert q_k.dtype == torch.float32
    assert _max_err(q_k.numpy(), q_d.numpy()) <= 5e-6
    ops = zolo_cuda.cuda_zolo_ops()
    g = ops.gram(torch.ones((3, 5, 4)))
    assert g.shape == (3, 4, 4)  # r-stack unrolled over the 2-D op


def test_polar_canonical_wide_is_row_major():
    a = torch.randn(3, 7)
    w, transposed = zolo.polar_canonical(a)
    assert transposed and w.shape == (7, 3) and w.is_contiguous()
    assert zolo.polar_canonical(a.mT.contiguous())[1] is False


def test_norms_match_reference():
    a_t, a_j = _both(50, 30, 1e3, seed=4)
    a_t = 3.0 * a_t
    a_j = 3.0 * a_j
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (30,),
                                      jnp.float64))
    got = norms.sigma_max_power(a_t, iters=8, v0=torch.from_numpy(v0.copy()))
    want = jnorms.sigma_max_power(a_j, iters=8)
    assert abs(float(got) - float(want)) <= 1e-13
    assert abs(float(norms.sigma_max_upper(a_t))
               - float(jnorms.sigma_max_upper(a_j))) <= 1e-13
    np.testing.assert_allclose(
        norms.frobenius_pair(a_t, 2 * a_t).numpy(),
        np.asarray(jnorms.frobenius_pair(a_j, 2 * a_j)), rtol=1e-14)
    # without v0 the start vector comes from a generator seeded with 0
    s1 = norms.sigma_max_power(a_t, iters=8)
    s2 = norms.sigma_max_power(a_t, iters=8)
    assert float(s1) == float(s2)
    assert abs(float(s1) - 3.0) < 1e-3
