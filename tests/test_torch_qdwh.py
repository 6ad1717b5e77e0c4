"""The port's QDWH-PD and scaled Newton against repro.core, on the CPU.

Same inputs (tests/conftest.make_matrix, numpy) through both packages:

* QDWH coefficients: the numpy half (``qdwh_coeffs_np``,
  ``qdwh_schedule_np``, ``qdwh_iter_count``) equal to the reference's
  exactly; the torch half within 1e-14 relative of ``jnp``'s in f64
  (``jnp.cbrt`` is ``torch.pow(., 1/3)`` here), and in l's dtype.
* ``qdwh_pd`` / ``qdwh_pd_static``: iterations (and converged) equal; Q
  within 1e-12 for kappa <= 1e4 (where the reference itself is within
  1e-12 of the exact polar factor), within twice the reference's own
  error beyond (the bound of tests/test_torch_zolo.py).
* ``scaled_newton_pd``: iterations and converged equal, Q within the same
  bound; a singular input gives NaN (the reference's inf/NaN), never an
  exception.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
from repro.core import coeffs as jcoeffs  # noqa: E402
from repro.core import newton as jnewton  # noqa: E402
from repro.core import qdwh as jqdwh  # noqa: E402
from repro_torch.core import coeffs, newton, qdwh  # noqa: E402

TOL = 1e-12


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))


def _exact_polar(a):
    u, _, vt = np.linalg.svd(a, full_matrices=False)
    return u @ vt


def _q_bound(q_j, a, kappa, stable=True):
    """max(1e-12, twice the reference's error against the exact polar
    factor); that error is itself <= 1e-12 for kappa <= 1e4 on a stable
    route (not on all-Cholesky QDWH, qr_iters=0)."""
    ref_err = _max_err(q_j, _exact_polar(a))
    if kappa <= 1e4 and stable:
        assert ref_err <= TOL
    return max(TOL, 2.0 * ref_err)


# --- coefficients ------------------------------------------------------------


@pytest.mark.parametrize("l", [1e-15, 1e-10, 2.59e-6, 1e-3, 0.1, 0.5, 0.9,
                               1.0 - 1e-12])
def test_qdwh_coeffs_match_reference(l):
    assert coeffs.qdwh_coeffs_np(l) == jcoeffs.qdwh_coeffs_np(l)
    got = coeffs.qdwh_coeffs(torch.tensor(l, dtype=torch.float64))
    want = jcoeffs.qdwh_coeffs(jnp.float64(l))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert abs(float(g) - float(w)) <= 1e-14 * abs(float(w))
    ca, cb, cc = got
    lu = coeffs.qdwh_l_update(torch.tensor(l, dtype=torch.float64),
                              ca, cb, cc)
    lu_j = jcoeffs.qdwh_l_update(jnp.float64(l), *want)
    assert abs(float(lu) - float(lu_j)) <= 1e-14 * float(lu_j)
    # a python number is taken as float64; an f32 bound stays f32
    assert coeffs.qdwh_coeffs(l)[0].dtype == torch.float64
    assert coeffs.qdwh_coeffs(torch.tensor(l, dtype=torch.float32))[2] \
        .dtype == torch.float32


@pytest.mark.parametrize("l0", [1e-12, 9.9e-5, 0.3])
def test_qdwh_schedule_and_iter_count_equal_reference(l0):
    for max_iters in (3, 8, 20):
        assert coeffs.qdwh_schedule_np(l0, max_iters=max_iters) == \
            jcoeffs.qdwh_schedule_np(l0, max_iters=max_iters)
    for kappa in (1.0 / l0, 9.06e3, 1e16):
        assert coeffs.qdwh_iter_count(kappa) == \
            jcoeffs.qdwh_iter_count(kappa)


# --- QDWH-PD -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jit_qdwh_pd():
    return jax.jit(functools.partial(jqdwh.qdwh_pd, want_h=False))


@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e8])
@pytest.mark.parametrize("m,n", [(64, 40), (48, 48)])
def test_qdwh_pd_matches_reference(m, n, kappa):
    a = np.asarray(make_matrix(m, n, kappa, seed=2))
    q_j, _, info_j = _jit_qdwh_pd()(jnp.asarray(a))
    q_t, h_t, info_t = qdwh.qdwh_pd(torch.from_numpy(a.copy()))
    assert q_t.dtype == torch.float64
    assert int(info_t.iterations) == int(info_j.iterations)
    assert bool(info_t.converged) == bool(info_j.converged) is True
    assert float(info_t.l_init) == pytest.approx(float(info_j.l_init),
                                                 rel=1e-6)
    assert _max_err(q_t.numpy(), q_j) <= _q_bound(q_j, a, kappa)
    np.testing.assert_allclose((q_t @ h_t).numpy(), a, atol=1e-12)


def test_qdwh_pd_given_l_and_max_iters_match_reference():
    a = np.asarray(make_matrix(40, 24, 1e3, seed=4))
    for kw in ({"l": 0.9e-3}, {"max_iters": 2}, {"l": 0.9e-3,
                                                 "chol_switch": 1e9}):
        q_j, _, info_j = jqdwh.qdwh_pd(jnp.asarray(a), want_h=False, **kw)
        q_t, h_t, info_t = qdwh.qdwh_pd(torch.from_numpy(a.copy()),
                                        want_h=False, **kw)
        assert h_t is None
        assert int(info_t.iterations) == int(info_j.iterations)
        assert bool(info_t.converged) == bool(info_j.converged)
        assert abs(float(info_t.residual) - float(info_j.residual)) <= \
            1e-10 * float(info_j.residual) + 1e-15
        assert _max_err(q_t.numpy(), q_j) <= TOL
    assert not bool(info_t.converged) or int(info_t.iterations) > 2


def test_qdwh_pd_f32_matches_reference():
    a = np.asarray(make_matrix(64, 40, 1e3, seed=5), np.float32)
    q_j, _, info_j = _jit_qdwh_pd()(jnp.asarray(a))
    q_t, _, info_t = qdwh.qdwh_pd(torch.from_numpy(a.copy()), want_h=False)
    eps = float(np.finfo(np.float32).eps)
    assert q_t.dtype == info_t.l_init.dtype == torch.float32
    assert int(info_t.iterations) == int(info_j.iterations)
    assert bool(info_t.converged) == bool(info_j.converged) is True
    ref_err = _max_err(q_j, _exact_polar(a.astype(np.float64)))
    assert _max_err(q_t.numpy(), q_j) <= max(16.0 * eps, 2.0 * ref_err)


# qr_iters = 0 (Cholesky from the start) only where it is stable
@pytest.mark.parametrize("kappa,qr_iters", [
    (1e2, None), (1e2, 0), (1e2, 2), (1e4, None), (1e4, 0), (1e4, 2),
    (1e8, None), (1e8, 2)])
def test_qdwh_pd_static_matches_reference(kappa, qr_iters):
    a = np.asarray(make_matrix(56, 40, kappa, seed=6))
    l0 = 0.9 / kappa
    q_j, _, info_j = jqdwh.qdwh_pd_static(jnp.asarray(a), l0=l0,
                                          qr_iters=qr_iters, want_h=False)
    q_t, h_t, info_t = qdwh.qdwh_pd_static(torch.from_numpy(a.copy()),
                                           l0=l0, qr_iters=qr_iters)
    assert int(info_t.iterations) == int(info_j.iterations)
    assert float(info_t.l_final) == float(info_j.l_final)
    assert float(info_t.l_init) == float(info_j.l_init)
    assert _max_err(q_t.numpy(), q_j) <= _q_bound(q_j, a, kappa,
                                                  stable=qr_iters != 0)
    np.testing.assert_allclose((q_t @ h_t).numpy(), a, atol=1e-12)
    sched = coeffs.qdwh_schedule_np(l0, max_iters=8)
    q_s, _, info_s = qdwh.qdwh_pd_static(torch.from_numpy(a.copy()),
                                         schedule=sched, qr_iters=qr_iters,
                                         want_h=False)
    assert torch.equal(q_s, q_t) and np.isnan(float(info_s.l_init))
    with pytest.raises(ValueError, match="schedule"):
        qdwh.qdwh_pd_static(torch.from_numpy(a.copy()))


# --- scaled Newton ------------------------------------------------------------


@pytest.mark.parametrize("kappa", [1e2, 1e4, 1e8])
def test_scaled_newton_matches_reference(kappa):
    a = np.asarray(make_matrix(48, 48, kappa, seed=7))
    q_j, _, info_j = jnewton.scaled_newton_pd(jnp.asarray(a), want_h=False)
    q_t, h_t, info_t = newton.scaled_newton_pd(torch.from_numpy(a.copy()))
    assert int(info_t.iterations) == int(info_j.iterations)
    assert bool(info_t.converged) == bool(info_j.converged)
    assert np.isnan(float(info_t.l_init))
    assert _max_err(q_t.numpy(), q_j) <= _q_bound(q_j, a, kappa)
    np.testing.assert_allclose((q_t @ h_t).numpy(), a, atol=1e-12)


def test_scaled_newton_misuse_and_singular_input():
    with pytest.raises(ValueError, match=r"\(6, 4\)"):
        newton.scaled_newton_pd(torch.zeros((6, 4), dtype=torch.float64))
    s = torch.eye(5, dtype=torch.float64)
    s[2, 2] = 0.0
    q, _, info = newton.scaled_newton_pd(s, want_h=False)  # no raise
    q_j, _, info_j = jnewton.scaled_newton_pd(jnp.asarray(s.numpy()),
                                              want_h=False)
    assert not np.isfinite(np.asarray(q_j)).all()
    assert torch.isnan(q).all()
    assert int(info.iterations) == int(info_j.iterations) == 1
    assert not bool(info.converged) and not bool(info_j.converged)


def test_scaled_newton_f32_runs_its_iterations_like_the_reference():
    # f32 on the linverse spectrum: the 10 eps stop is not reached in
    # either package (ROADMAP Queue C); iterations and converged equal,
    # and Q within the f32 accuracy limit
    from repro_torch.configs import svd_paper

    a, _ = svd_paper.synthesize("linverse", n=256, dtype=torch.float32,
                                device="cpu")
    q_j, _, info_j = jnewton.scaled_newton_pd(jnp.asarray(a.numpy()),
                                              want_h=False)
    q_t, _, info_t = newton.scaled_newton_pd(a, want_h=False)
    assert q_t.dtype == torch.float32
    assert int(info_t.iterations) == int(info_j.iterations) == 30
    assert bool(info_t.converged) == bool(info_j.converged) is False
    exact = _exact_polar(a.double().numpy())
    assert _max_err(q_t.numpy(), exact) <= 1e-4
    assert _max_err(q_j, exact) <= 1e-4
