"""The port's kernels K1 (fused shifted Gram) and K2 (r-term combine).

On the CPU every wrapper runs its plain PyTorch version; those are held
against the reference's jnp oracles (``repro.kernels.ref``) and against
the Pallas kernels in interpret mode (``repro.kernels.ops`` off-TPU), on
the same inputs made with numpy.  Tolerances: 1e-5 of max|result| in f32
(the summation order differs); for a bf16 output, one bf16 ulp plus the
f32 sums' forward error bound (``_sum_bound``), elementwise.

The ``gpu``-marked tests launch the CUDA kernels and hold them against
the plain versions; they need a card and skip without one.  They need
neither JAX nor the reference package (the machine with the card has
neither), so those are imported by the ``jx`` fixture of the CPU tests
only; on the card run ``pytest --noconftest -m gpu`` on this file.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import gram as kgram  # noqa: E402
from repro_torch.kernels import grouped_combine as kcomb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F32_REL = 1e-5
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The reference: jax.numpy, repro.kernels.{ops, ref}, repro.core.zolo."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import zolo
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return types.SimpleNamespace(jnp=jnp, ops=jops, ref=jref, zolo=zolo)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _pair(jx, x_np, dtype):
    """The same values as a torch tensor and a jnp array of ``dtype``."""
    t = torch.from_numpy(np.asarray(x_np, np.float32)).to(TORCH_DTYPES[dtype])
    exact = t.float().numpy()  # bf16 values are exact in f32
    return t, jx.jnp.asarray(exact).astype(getattr(jx.jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_rel(got, want, rel=F32_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _bf16_ulp(y):
    y = np.abs(np.asarray(y, np.float64))
    e = np.floor(np.log2(np.where(y > 0, y, 1.0)))
    return np.where(y > 0, 2.0 ** (e - 7), 2.0 ** -133)


def _assert_bf16_ulp(got, want, slack=0.0):
    got, want = _np(got), _np(want)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want) + slack)


def _sum_bound(x, t, a, mhat, xw):
    """Forward error bound of an f32 sum mhat (xw x + sum_j a_j t_j),
    doubled for two implementations: (2r + 2) eps(f32) |mhat| (|xw x| +
    sum_j |a_j t_j|).  Two correct f32 sums (fused multiply-adds vs
    separate products) differ by up to this, which shows in a bf16 result
    only where the sum cancels."""
    x, t = _np(x).astype(np.float64), _np(t).astype(np.float64)
    a = np.abs(np.asarray(a, np.float64))
    mag = abs(xw) * np.abs(x) + np.einsum("j,jmn->mn", a, np.abs(t))
    return (2 * len(a) + 2) * np.finfo(np.float32).eps * abs(mhat) * mag


def _floor(g):
    """The clamp floor 8 eps(f32) max diag G of a Gram matrix."""
    return 8.0 * np.finfo(np.float32).eps * float(np.max(np.diag(g)))


# --- K1: fused shifted Gram ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(64, 64), (200, 72), (37, 130)])
@pytest.mark.parametrize("c", [0.0, 0.73])
def test_gram_plain_matches_reference_oracle(m, n, c, dtype, rng, jx):
    a_t, a_j = _pair(jx, rng.standard_normal((m, n)), dtype)
    got = ops.gram(a_t, c)
    assert got.dtype == torch.float32 and got.shape == (n, n)
    _assert_rel(got, jx.ref.gram_ref(a_j, c))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", ["zero", "below_floor", "above_floor"])
def test_gram_plain_matches_pallas_interpret(shift, dtype, rng, jx):
    # n <= one Pallas tile, where its tile-local clamp is the global one
    m, n = 200, 72
    a_t, a_j = _pair(jx, rng.standard_normal((m, n)), dtype)
    floor = _floor(_np(ops.gram(a_t)))
    c = {"zero": 0.0, "below_floor": 0.25 * floor,
         "above_floor": 4.0 * floor}[shift]
    got = ops.gram(a_t, c)
    want = jx.ops.gram(a_j, c, use_pallas=True)
    _assert_rel(got, want)
    c_eff = float(ref.clamp_shift(c, ops.gram(a_t), torch.float32))
    # below the floor the clamp fires (c_eff is the floor), else c stays
    assert c_eff == pytest.approx(floor if shift == "below_floor" else c,
                                  rel=1e-6)


@pytest.mark.parametrize("c_scale", [0.25, 4.0])
def test_gram_plain_clamps_against_global_diagonal(c_scale, rng, jx):
    # n > 256: the Pallas kernel's tile-local clamp and the engine's
    # global one differ here; the port follows the engine (zolo._gram)
    x = rng.standard_normal((300, 260)).astype(np.float32)
    x[:, 5] *= 30.0  # one dominant diagonal entry in the first tile
    a_t, a_j = _pair(jx, x, "float32")
    c = c_scale * _floor(_np(ops.gram(a_t)))
    _assert_rel(ops.gram(a_t, torch.tensor(c)),
                jx.zolo._gram(a_j, jx.jnp.float32(c)))


def test_gram_plain_keeps_f64_and_batches():
    x = np.random.default_rng(3).standard_normal((3, 20, 9))
    t = torch.from_numpy(x)
    g = ref.gram_ref(t, 1e-30)  # f64: accumulates and shifts unclamped
    assert g.dtype == torch.float64
    want = np.einsum("bmk,bmn->bkn", x, x) + 1e-30 * np.eye(9)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-13, atol=1e-13)


# --- K2: r-term combine ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("xw", [0.0, 1.0])
def test_combine_plain_matches_reference_and_pallas(r, xw, dtype, rng, jx):
    m, n = 200, 72
    x_t, x_j = _pair(jx, rng.standard_normal((m, n)), dtype)
    t_t, t_j = _pair(jx, rng.standard_normal((r, m, n)), dtype)
    a = rng.standard_normal(r)
    mhat = 0.987
    got = ops.grouped_combine(x_t, t_t, torch.tensor(a), mhat, xw)
    assert got.dtype == x_t.dtype
    jnp = jx.jnp
    for want in (jx.ref.grouped_combine_ref(x_j, t_j, jnp.asarray(a), mhat,
                                            xw),
                 jx.ops.grouped_combine(x_j, t_j, jnp.asarray(a, jnp.float32),
                                        mhat, xw, use_pallas=True)):
        if dtype == "float32":
            _assert_rel(got, want)
        else:
            _assert_bf16_ulp(got, want, _sum_bound(x_t, t_t, a, mhat, xw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_polar_update_plain_matches_pallas(dtype, rng, jx):
    x_t, x_j = _pair(jx, rng.standard_normal((130, 70)), dtype)
    t_t, t_j = _pair(jx, rng.standard_normal((3, 130, 70)), dtype)
    a = rng.standard_normal(3)
    got = ops.polar_update(x_t, t_t, torch.tensor(a), 0.75)
    want = jx.ops.polar_update(x_j, t_j, jx.jnp.asarray(a, jx.jnp.float32),
                              0.75)
    if dtype == "float32":
        _assert_rel(got, want)
    else:
        _assert_bf16_ulp(got, want, _sum_bound(x_t, t_t, a, 0.75, 1.0))


def test_combine_plain_mixed_dtypes_accumulate_in_f32(rng):
    # a bf16 iterate with f32 terms (the engine's bf16 case)
    x = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((2, 40, 24)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = ops.polar_update(xb, t, torch.tensor([0.5, -2.0]), 1.5)
    want = (1.5 * (xb.float() + 0.5 * t[0] - 2.0 * t[1])).numpy()
    assert got.dtype == torch.bfloat16
    _assert_bf16_ulp(got, want, _sum_bound(xb, t, [0.5, -2.0], 1.5, 1.0))


def test_wrappers_refuse_devices_without_a_path():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.gram(a)
    with pytest.raises(ValueError, match="device"):
        ops.polar_update(a, a[None], torch.ones(1), 1.0)


def test_launch_wrappers_refuse_cpu_tensors():
    a = torch.ones((8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kgram.gram_kernel_call(a)
    with pytest.raises(ValueError, match="CUDA"):
        kcomb.grouped_combine_kernel_call(a, a[None], [1.0], 1.0)
    assert kgram.gram_plain is ref.gram_ref
    assert kcomb.grouped_combine_plain is ref.grouped_combine_ref


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the "
                    "card (python3 chip_smoke.py, or pytest -m gpu there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(300, 200), (1000, 333), (129, 257)])
@pytest.mark.parametrize("shift", ["none", "zero", "below_floor",
                                   "above_floor"])
def test_gram_kernel_matches_plain(cuda, m, n, dtype, shift):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((m, n), generator=gen, device=cuda).to(dtype)
    floor = _floor(ref.gram_ref(a).cpu().numpy())
    c = {"none": 0.0, "zero": torch.zeros((), device=cuda),
         "below_floor": 0.25 * floor, "above_floor": 4.0 * floor}[shift]
    before = kgram.launches
    got = ops.gram(a, c)
    assert kgram.launches == before + 1
    want = ref.gram_ref(a, c)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, got.mT)  # mirrored tiles: exactly symmetric
    err = (got - want).abs().max().item()
    assert err <= 5e-5 * want.abs().max().item()
    if shift in ("below_floor", "above_floor"):
        # the applied shift, averaged over the diagonal: max(c, floor)
        applied = (torch.diagonal(got).double()
                   - torch.diagonal(ops.gram(a)).double()).mean().item()
        assert applied == pytest.approx(max(c, floor), rel=0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,tdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("r", [1, 4, 8])
@pytest.mark.parametrize("shape", [(200, 72), (301, 77)])
def test_combine_kernel_matches_plain(cuda, xdt, tdt, r, shape):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda).to(xdt)
    t = torch.randn((r,) + shape, generator=gen, device=cuda).to(tdt)
    a = torch.randn(r, generator=gen, device=cuda)
    for xw in (0.0, 1.0):
        before = kcomb.launches
        got = ops.grouped_combine(x, t, a, torch.tensor(0.9, device=cuda),
                                  xw)
        assert kcomb.launches == before + 1
        want = ref.grouped_combine_ref(x, t, a, 0.9, xw)
        torch.cuda.synchronize()
        assert got.dtype == xdt
        if xdt == torch.float32:
            _assert_rel(got.cpu(), want.cpu(), rel=1e-6)
        else:
            _assert_bf16_ulp(got.cpu(), want.cpu(),
                             _sum_bound(x.cpu(), t.cpu(), a.cpu(), 0.9, xw))


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    a64 = torch.ones((8, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="takes"):
        ops.gram(a64)
    with pytest.raises(ValueError, match="row-major"):
        ops.gram(torch.ones((8, 4), device=cuda).mT)
    x = torch.ones((8, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.polar_update(x, torch.ones((1, 4, 8), device=cuda).mT, [1.0],
                         1.0)
    with pytest.raises(ValueError, match="r <="):
        ops.polar_update(x, torch.ones((9, 8, 4), device=cuda), [1.0] * 9,
                         1.0)
