"""The port's block-Jacobi eigensolvers and Jacobi SVD against repro.core.

Same inputs (numpy, ``tests/conftest.make_matrix``) through both
packages, in f64.  The tournament schedule must be equal exactly.  The
sweeps rotate by eigenvectors of small subproblems whose signs LAPACK
may choose differently in the two packages, so raw eigenvectors are not
compared: eigenvalues (and singular values) within 1e-12 relative to
the largest, and the reconstruction and orthogonality within 1e-12.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import make_matrix  # noqa: E402
from repro.core import eig as jeig  # noqa: E402
from repro.core import svd as jsvd  # noqa: E402
from repro_torch.core import eig  # noqa: E402
from repro_torch.core import svd as tsvd  # noqa: E402

TOL = 1e-12


def _sym(n, seed, kappa=1e3):
    a = np.asarray(make_matrix(n, n, kappa, seed=seed))
    return a @ a.T + np.diag(np.linspace(-1.0, 1.0, n))


def _orth_err(v):
    v = np.asarray(v)
    return float(np.abs(v.T @ v - np.eye(v.shape[1])).max())


@pytest.mark.parametrize("b", [2, 4, 6, 8, 10, 64])
def test_round_robin_schedule_equals_reference(b):
    got = eig.round_robin_schedule(b)
    want = jeig.round_robin_schedule(b)
    assert got.dtype == want.dtype and got.shape == (b - 1, b // 2, 2)
    np.testing.assert_array_equal(got, want)
    # every unordered pair exactly once, each round disjoint
    pairs = {tuple(p) for r in got for p in r}
    assert len(pairs) == b * (b - 1) // 2
    for r in got:
        assert len(set(r.reshape(-1))) == b


def test_round_robin_schedule_rejects_odd():
    with pytest.raises(ValueError, match="b=5"):
        eig.round_robin_schedule(5)


@functools.lru_cache(maxsize=None)
def _jit_block_jacobi(nb):
    return jax.jit(functools.partial(jeig.block_jacobi_eigh, nb=nb))


def _eig_checks(h, w, v, w_ref):
    scale = float(np.abs(w_ref).max())
    w, v = w.numpy(), v.numpy()
    assert np.all(np.diff(w) >= 0)  # ascending
    assert float(np.abs(w - np.asarray(w_ref)).max()) <= TOL * scale
    assert float(np.abs(h @ v - v * w).max()) <= TOL * scale
    assert _orth_err(v) <= TOL


@pytest.mark.parametrize("n,nb", [(32, 8), (48, 8), (64, 16)])
def test_block_jacobi_eigh_matches_reference(n, nb):
    h = _sym(n, seed=n)
    w_j, v_j = _jit_block_jacobi(nb)(jnp.asarray(h))
    w, v = eig.block_jacobi_eigh(torch.from_numpy(h.copy()), nb=nb)
    _eig_checks(h, w, v, w_j)
    _eig_checks(h, w, v, np.linalg.eigvalsh(h))
    hv = np.asarray(h) @ np.asarray(v_j) - np.asarray(v_j) * np.asarray(w_j)
    assert float(np.abs(hv).max()) <= TOL * float(np.abs(w_j).max())


@pytest.mark.parametrize("n,nb", [(30, 8), (40, 16), (17, 4)])
def test_padded_block_jacobi_eigh_matches_reference(n, nb):
    h = _sym(n, seed=3 * n)
    w_j, _ = jeig.padded_block_jacobi_eigh(jnp.asarray(h), nb=nb)
    h_t = torch.from_numpy(h.copy())
    w, v = eig.padded_block_jacobi_eigh(h_t, nb=nb)
    assert w.shape == (n,) and v.shape == (n, n)
    assert torch.equal(h_t, torch.from_numpy(h))  # input untouched
    _eig_checks(h, w, v, w_j)


def test_block_jacobi_eigh_rejects_bad_blocking():
    with pytest.raises(ValueError, match="padded_block_jacobi_eigh"):
        eig.block_jacobi_eigh(torch.eye(24, dtype=torch.float64), nb=8)


@pytest.mark.parametrize("m,n,nb", [(48, 32, 8), (40, 40, 4), (64, 32, 16)])
def test_jacobi_svd_matches_reference(m, n, nb):
    a = np.asarray(make_matrix(m, n, 1e4, seed=m + n))
    u_j, s_j, vh_j = jsvd.jacobi_svd(jnp.asarray(a), nb=nb)
    u, s, vh = tsvd.jacobi_svd(torch.from_numpy(a.copy()), nb=nb)
    assert u.shape == (m, n) and s.shape == (n,) and vh.shape == (n, n)
    s_exact = np.linalg.svd(a, compute_uv=False)
    assert float(np.abs(s.numpy() - np.asarray(s_j)).max()) <= TOL
    assert float(np.abs(s.numpy() - s_exact).max()) <= TOL
    rec = (u * s) @ vh
    assert float(np.abs(rec.numpy() - a).max()) <= TOL
    rec_j = (np.asarray(u_j) * np.asarray(s_j)) @ np.asarray(vh_j)
    assert float(np.abs(rec.numpy() - rec_j).max()) <= TOL
    assert _orth_err(u) <= 1e-11 and _orth_err(vh.mT) <= TOL


def test_jacobi_svd_misuse_raises():
    with pytest.raises(ValueError, match=r"\(2, 8, 8\)"):
        tsvd.jacobi_svd(torch.zeros((2, 8, 8)), nb=4)
    with pytest.raises(ValueError, match="nb=8"):
        tsvd.jacobi_svd(torch.zeros((16, 24)), nb=8)


def test_jacobi_svd_f32_keeps_u_orthogonal_where_the_reference_does_not():
    # the port computes each block rotation in f64 (a deliberate
    # divergence, ROADMAP Queue C): on the f32 linverse spectrum
    # (kappa 9.06e3) the reference's f32 Gram-based rotations leave
    # orth(U) above the f32 limit of 1e-4; the port's stay far below it
    from repro_torch.configs import svd_paper

    a, s_true = svd_paper.synthesize("linverse", n=128,
                                     dtype=torch.float32, device="cpu")
    u, s, vh = tsvd.jacobi_svd(a, nb=32)
    u_j, _, _ = jsvd.jacobi_svd(jnp.asarray(a.numpy()), nb=32)
    assert u.dtype == s.dtype == vh.dtype == torch.float32
    assert float(tsvd.orthogonality(u.double())) < 1e-6
    assert float(tsvd.orthogonality(vh.double().mT)) < 1e-6
    assert float(tsvd.orthogonality(
        torch.from_numpy(np.asarray(u_j, np.float64)))) > 1e-4
    assert float((s.double() - s_true).abs().max() / s_true[0]) < 1e-5


def test_one_sweep_cap_for_both_jacobi_solvers(monkeypatch):
    """The eigensolver (the registered ``jacobi`` backend too) and
    ``jacobi_svd`` share one sweep cap, above the reference's 12 and 16,
    which leave the linverse spectrum unconverged at n = 2,048."""
    import inspect

    from repro_torch.core import registry

    def cap(fn):
        return inspect.signature(fn).parameters["max_sweeps"].default

    for fn in (eig.block_jacobi_eigh, eig.padded_block_jacobi_eigh,
               tsvd.jacobi_svd):
        assert cap(fn) == eig.MAX_SWEEPS
    assert eig.MAX_SWEEPS > max(cap(jeig.padded_block_jacobi_eigh),
                                cap(jsvd.jacobi_svd))
    seen = []
    real = eig.block_jacobi_eigh

    def spy(h, **kw):
        seen.append(kw["max_sweeps"])
        return real(h, **kw)

    monkeypatch.setattr(eig, "block_jacobi_eigh", spy)
    h = torch.from_numpy(_sym(64, 3))
    w, v = registry.get_eig("jacobi").fn(h, nb=8)
    assert seen == [eig.MAX_SWEEPS]
    torch.testing.assert_close(v @ torch.diag(w) @ v.mT, h, rtol=0,
                               atol=TOL * float(h.abs().max()))
