"""The port's structured Householder QR against repro.core.structured_qr.

Same inputs (tests/conftest.make_matrix, numpy) through both packages, in
f64.  The port factors each panel with LAPACK's geqrf and forms T by a
triangular solve (the reference: a column loop and the larft
recurrence); both are the same Householder QR, so Q1 Q2^T, R and the
reconstructions agree within 1e-12, and at the tiny shift of the
row-wise stability case the identity block's backward error stays below
1e-14 (the reference's own bound).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
from repro.core import structured_qr as jsqr  # noqa: E402
from repro_torch.core import structured_qr as sqr  # noqa: E402

TOL = 1e-12


def _both(m, n, kappa, seed):
    a = np.array(make_matrix(m, n, kappa, seed=seed))
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def _max_err(x, y):
    return float(np.max(np.abs(np.asarray(x) - np.asarray(y))))


@pytest.mark.parametrize("m,n,blk", [(64, 32, 8), (100, 60, 16),
                                     (128, 96, 32), (90, 50, 32),
                                     (200, 200, 32)])
def test_q1q2_matches_reference(m, n, blk):
    x_t, x_j = _both(m, n, 50.0, seed=m + n)
    sqc = 0.37
    q1_j, q2_j = jsqr.structured_qr_q1q2(x_j, jnp.float64(sqc), block=blk)
    q1, q2 = sqr.structured_qr_q1q2(
        x_t, torch.tensor(sqc, dtype=torch.float64), block=blk)
    assert q1.shape == (m, n) and q2.shape == (n, n)
    want = np.asarray(q1_j) @ np.asarray(q2_j).T
    assert _max_err((q1 @ q2.mT).numpy(), want) <= TOL
    # the explicit factors themselves, column signs included
    assert _max_err(q1.numpy(), q1_j) <= TOL
    assert _max_err(q2.numpy(), q2_j) <= TOL
    eye = torch.eye(n, dtype=torch.float64)
    assert float(torch.linalg.matrix_norm(q1.mT @ q1 + q2.mT @ q2 - eye)) \
        < TOL


def test_factor_and_reconstruction_match_reference():
    m, n, blk = 128, 64, 32
    x_t, x_j = _both(m, n, 100.0, seed=5)
    sqc = 0.61
    r_j, v_j, t_j = jsqr.structured_qr_factor(x_j, jnp.float64(sqc),
                                              block=blk)
    r, v_all, t_all = sqr.structured_qr_factor(
        x_t, torch.tensor(sqc, dtype=torch.float64), block=blk)
    assert _max_err(r.numpy(), r_j) <= TOL
    assert _max_err(v_all.numpy(), v_j) <= TOL
    assert _max_err(t_all.numpy(), t_j) <= TOL
    assert float(torch.abs(torch.tril(r, -1)).max()) == 0.0
    q1, q2 = sqr.apply_q_structured(v_all, t_all, m, block=blk)
    eye = torch.eye(n, dtype=torch.float64)
    assert float(torch.linalg.matrix_norm(q1 @ r - x_t)) < TOL
    assert float(torch.linalg.matrix_norm(q2 @ r - sqc * eye)) < TOL


def test_rowwise_stability_at_tiny_shift():
    # the property that makes the Householder first iteration backward
    # stable: at sqrt(c) ~ 1e-9 on an ill-conditioned X, the identity
    # block's backward error stays absolute-eps
    m, n = 128, 64
    x_t, x_j = _both(m, n, 1e11, seed=7)
    sqc = 9.6e-10
    r, v_all, t_all = sqr.structured_qr_factor(
        x_t, torch.tensor(sqc, dtype=torch.float64), block=32)
    q1, q2 = sqr.apply_q_structured(v_all, t_all, m, block=32)
    eye = torch.eye(n, dtype=torch.float64)
    assert float(torch.linalg.matrix_norm(q2 @ r - sqc * eye)) < 1e-14
    assert float(torch.linalg.matrix_norm(q1 @ r - x_t)) < 1e-13
    assert float(torch.linalg.matrix_norm(q1.mT @ q1 + q2.mT @ q2 - eye)) \
        < TOL
    # Q1 Q2^T itself carries the kappa = 1e11 conditioning: two f64 QRs
    # of one stack agree to ~3e-8 there (the reference against its own
    # dense oracle too), so the port is held to twice the reference's
    # distance from the oracle
    q1_j, q2_j = jsqr.structured_qr_q1q2(x_j, jnp.float64(sqc), block=32)
    d1_j, d2_j = jsqr.dense_stacked_qr_q1q2(x_j, jnp.float64(sqc))
    want = np.asarray(q1_j) @ np.asarray(q2_j).T
    ref_err = _max_err(want, np.asarray(d1_j) @ np.asarray(d2_j).T)
    assert _max_err((q1 @ q2.mT).numpy(), want) <= 2.0 * ref_err


def test_panel_convention_matches_reference_with_zero_tails():
    # LAPACK's dlarfg (through geqrf): beta = -sign(alpha) ||x||,
    # tau = (beta - alpha) / beta; a zero tail gives tau = 0 with the
    # pivot left as alpha — here column 0 (already upper triangular) and
    # column 3 (all zero), the reference's `safe` branch
    rng = np.random.default_rng(3)
    p = rng.standard_normal((40, 8))
    p[1:, 0] = 0.0
    p[:, 3] = 0.0
    p[0, 5] = -abs(p[0, 5])  # a negative pivot: beta > 0
    got = sqr._householder_panel(torch.from_numpy(p.copy()))
    want = jsqr._householder_panel(jnp.asarray(p))
    v, tau, t, r_top = (x.numpy() for x in got)
    assert tau[0] == tau[3] == 0.0
    assert r_top[0, 0] == p[0, 0]  # pivot kept
    for g, w in zip((v, tau, t, r_top), want):
        assert _max_err(g, w) <= TOL
    # T is the block reflector of the panel: (I - V T V^T)^T P = [R; 0]
    h = np.eye(40) - v @ t @ v.T
    np.testing.assert_allclose((h.T @ p)[:8], r_top, atol=1e-12)
    np.testing.assert_allclose((h.T @ p)[8:], 0.0, atol=1e-12)


@pytest.mark.parametrize("shape", [(60, 12), (3, 50, 16)])
def test_cholesky_qr2_matches_reference(shape):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape)
    got = sqr.cholesky_qr2(torch.from_numpy(x.copy()), shift_scale=2.0)
    want = jsqr.cholesky_qr2(jnp.asarray(x), shift_scale=2.0)
    assert got.shape == shape
    assert _max_err(got.numpy(), want) <= TOL
    k = shape[-1]
    gram = got.mT @ got
    assert float((gram - torch.eye(k, dtype=got.dtype)).abs().max()) < 1e-13


def test_dense_oracle_and_flop_model_match_reference():
    x_t, x_j = _both(70, 30, 20.0, seed=2)
    q1, q2 = sqr.dense_stacked_qr_q1q2(x_t, torch.tensor(0.2,
                                                          dtype=torch.float64))
    q1_j, q2_j = jsqr.dense_stacked_qr_q1q2(x_j, jnp.float64(0.2))
    assert _max_err((q1 @ q2.mT).numpy(),
                    np.asarray(q1_j) @ np.asarray(q2_j).T) <= TOL
    for args in ((10_000, 5_000, 64), (12_000, 12_000, 32), (96, 64, 16)):
        assert sqr.structured_qr_flops(*args) == \
            jsqr.structured_qr_flops(*args)


def test_misuse_raises_value_error():
    x = torch.zeros((40, 30), dtype=torch.float64)
    with pytest.raises(ValueError, match="block=32"):
        sqr.structured_qr_factor(x, 0.5, block=32)
    with pytest.raises(ValueError, match=r"\(20, 32\)"):
        sqr.structured_qr_factor(torch.zeros((20, 32)), 0.5, block=32)
