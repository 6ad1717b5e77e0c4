"""The small modules ported with the sharding layer, each against the
reference:

* ``core.coeffs.zolo_fn_scalar`` / ``zolo_fn_product`` (the cases of
  ``tests/test_coeffs.py``: partial fraction = product, hat-Z(1) = 1, the
  l-update, the range) and their values against the reference's;
* ``core.registry.unregister_polar`` / ``unregister_eig`` (the registry
  round trip of ``tests/test_dist.py``);
* the PowerSGD helpers of ``optim.compression`` on the reference's
  draws (the cases of ``tests/test_optim.py``, and each step against the
  reference's);
* ``configs.svd_paper.QR_SHAPES`` / ``QR_CPU_SHAPES``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import svd_paper as JP  # noqa: E402
from repro.core import coeffs as JC  # noqa: E402
from repro.optim import compression as JCP  # noqa: E402
from repro_torch.configs import svd_paper as P  # noqa: E402
from repro_torch.core import coeffs as C  # noqa: E402
from repro_torch.core import registry  # noqa: E402
from repro_torch.optim import compression as CP  # noqa: E402

F64 = torch.float64
# (l, r) pairs over the ranges the reference's property tests draw from
LR_CASES = [(1e-6, 1), (3e-5, 2), (1e-3, 3), (2e-2, 4), (0.1, 6),
            (0.5, 8)]


@pytest.mark.parametrize("l,r", LR_CASES)
def test_partial_fraction_equals_product(l, r):
    c, a, mh = C.zolo_coeffs(torch.tensor(l, dtype=F64), r)
    x = torch.linspace(l, 1.0, 9, dtype=F64)
    torch.testing.assert_close(C.zolo_fn_scalar(x, c, a, mh),
                               C.zolo_fn_product(x, c, mh),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("l,r", LR_CASES)
def test_scaled_function_properties(l, r):
    c, a, mh = C.zolo_coeffs(torch.tensor(l, dtype=F64), r)
    # hat-Z(1) = 1 by construction
    assert abs(float(C.zolo_fn_scalar(torch.tensor(1.0, dtype=F64), c, a,
                                      mh)) - 1.0) < 1e-12
    # the l-update equals the function value at l and improves the bound
    l_next = float(C.zolo_l_update(torch.tensor(l, dtype=F64), c, mh))
    f_l = float(C.zolo_fn_scalar(torch.tensor(l, dtype=F64), c, a, mh))
    assert abs(l_next - f_l) < 1e-12
    assert l_next > l
    # maps [l, 1] into [l_next, ~1+eps]
    fx = C.zolo_fn_scalar(torch.linspace(l, 1.0, 64, dtype=F64), c, a, mh)
    assert float(fx.min()) >= l_next - 1e-12
    assert float(fx.max()) <= 2.0 - l_next + 1e-12


@pytest.mark.parametrize("l,r", [(2e-2, 2), (0.1, 3), (0.5, 5)])
def test_function_values_match_the_reference(l, r):
    """Both forms at the same points against the reference's, each
    package on its own coefficients (which agree within 1e-13 for
    l >= 1e-2; ROADMAP Queue C): the reference's from its host twin
    ``zolo_coeffs_np`` (the same values within 1e-13; its jnp form takes
    seconds eagerly)."""
    jc, ja, jm = JC.zolo_coeffs_np(l, r)
    c, a, mh = C.zolo_coeffs(torch.tensor(l, dtype=F64), r)
    xs = np.linspace(l, 1.0, 17)
    ref_s = np.asarray(JC.zolo_fn_scalar(jnp.asarray(xs), jc, ja, jm))
    ref_p = np.asarray(JC.zolo_fn_product(jnp.asarray(xs), jc, jm))
    x = torch.from_numpy(xs)
    np.testing.assert_allclose(C.zolo_fn_scalar(x, c, a, mh).numpy(), ref_s,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(C.zolo_fn_product(x, c, mh).numpy(), ref_p,
                               rtol=1e-12, atol=0)


def test_registry_unregister_round_trip():
    def dummy(a, **kw):
        return a, None, None

    def dummy_eig(h, **kw):
        return torch.linalg.eigh(h)

    registry.register_polar("_test_dummy", description="test-only")(dummy)
    registry.register_eig("_test_dummy_eig")(dummy_eig)
    try:
        assert registry.get_polar("_test_dummy").fn is dummy
        assert "_test_dummy" in registry.list_polar()
        assert "_test_dummy_eig" in registry.list_eig()
        with pytest.raises(ValueError, match="already registered"):
            registry.register_polar("_test_dummy")(lambda a, **kw: None)
        assert registry.register_polar("_test_dummy")(dummy) is dummy
    finally:
        registry.unregister_polar("_test_dummy")
        registry.unregister_eig("_test_dummy_eig")
    assert "_test_dummy" not in registry.list_polar()
    assert "_test_dummy_eig" not in registry.list_eig()
    with pytest.raises(ValueError, match="unknown polar method"):
        registry.get_polar("_test_dummy")
    # unregistering what is not there is a no-op, as in the reference
    registry.unregister_polar("_test_dummy")
    registry.unregister_eig("_test_dummy_eig")


def _ref_state(shape, rank, key):
    st = JCP.init_compression_state(jnp.zeros(shape, jnp.float32), rank,
                                    key=jax.random.PRNGKey(key))
    return np.asarray(st["q"])


def test_compression_error_feedback(rng):
    """Error feedback makes the compressed stream unbiased over time, and
    every step equals the reference's from the reference's draw of q."""
    g_list = [rng.standard_normal((32, 48)).astype(np.float32)
              for _ in range(5)]
    q0 = _ref_state((32, 48), 4, 0)
    st = CP.init_compression_state(torch.from_numpy(g_list[0]), rank=4)
    assert st["q"].shape == (48, 4) and st["q"].dtype == torch.float32
    assert torch.equal(st["err"], torch.zeros(32, 48))
    err, q = st["err"], torch.from_numpy(q0)
    jerr, jq = jnp.zeros((32, 48), jnp.float32), jnp.asarray(q0)
    total_hat = torch.zeros(32, 48)
    for g in g_list:
        g_hat, err, q = CP.compress_decompress(torch.from_numpy(g), err, q,
                                               rank=4)
        jg_hat, jerr, jq = JCP.compress_decompress(jnp.asarray(g), jerr, jq,
                                                   rank=4)
        total_hat = total_hat + g_hat
        for ours, theirs in ((g_hat, jg_hat), (err, jerr), (q, jq)):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                       atol=1e-4 * np.abs(theirs).max())
    total = torch.from_numpy(sum(g_list))
    torch.testing.assert_close(total_hat + err, total, rtol=0, atol=1e-3)


def test_compression_exact_for_lowrank(rng):
    """A gradient of rank <= k is transmitted exactly (after the subspace
    warms up), from the reference's draw of q."""
    u = rng.standard_normal((40, 3)).astype(np.float32)
    v = rng.standard_normal((24, 3)).astype(np.float32)
    g = torch.from_numpy(u @ v.T)
    err = torch.zeros_like(g)
    q = torch.from_numpy(_ref_state((40, 24), 4, 1))
    for _ in range(3):
        g_hat, err, q = CP.compress_decompress(g, err, q, rank=4)
    assert float((g_hat - g).abs().max()) < 1e-4
    # lowrank_factor is the step compress_decompress takes: G ~= P Q^T
    p, qq = CP.lowrank_factor(g, q, rank=4)
    assert float((p @ qq.mT - g).abs().max()) < 1e-4


def test_init_compression_state_draws_from_its_generator():
    param = torch.zeros(3, 16, 8)
    a = CP.init_compression_state(param, 2)
    b = CP.init_compression_state(param, 2)
    c = CP.init_compression_state(
        param, 2, generator=torch.Generator().manual_seed(5))
    assert a["q"].shape == (3, 8, 2) and a["err"].shape == (3, 16, 8)
    assert torch.equal(a["q"], b["q"]) and not torch.equal(a["q"], c["q"])


def test_qr_shapes_match_the_reference():
    assert P.QR_SHAPES == JP.QR_SHAPES == [(10_000, 5_000), (20_000, 10_000)]
    assert P.QR_CPU_SHAPES == JP.QR_CPU_SHAPES
