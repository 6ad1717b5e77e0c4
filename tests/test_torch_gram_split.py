"""K1's f32 split over m and K2's single launch: the rules on the CPU, the
kernels on the card.

On the CPU: ``kernels/gram.py::gram_split`` (S, the slices of m each tile
of the ``"simt"`` route sums over, a rule of the shape and the SM count),
the slices it cuts, the tile rule, the f32 layout rule (an A of either
major read as it lies, but for a column-major one with no float4 columns
where m is not split, copied row-major once) and K2's scalar-argument
rule (a python number by value, a tensor by pointer).  These read
shapes, strides and dtypes only, so CPU tensors stand in for CUDA ones.
This file imports no JAX.

The ``gpu``-marked tests hold the f32 kernel to its plain version within
5e-5 of max|G| (f32 sums over m rows in another order), exactly symmetric
and bitwise the same over two launches, at c = 0 and c > 0, and count K2's
device operations a call with ``torch.profiler``.  On the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_gram_split.py``.
"""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gram as kgram  # noqa: E402
from repro_torch.kernels import grouped_combine as kcomb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SMS = 132  # an H100 SXM
MUON_SHAPES = [(2048, 1408), (2048, 2048), (2048, 64), (3352, 768),
               (1536, 768), (4096, 1024)]
LARGE_SHAPES = [(11_999, 11_999), (12_288, 4096), (6144, 4096),
                (3072, 4096)]


@pytest.mark.parametrize("m,n", LARGE_SHAPES,
                         ids=lambda v: str(v))
def test_gram_split_keeps_the_large_shapes_unsplit(m, n):
    assert kgram.gram_split(m, n, SMS) == 1


@pytest.mark.parametrize("m,n", [(5, 64), (kgram.GRAM_MIN_SLICE_ROWS - 1,
                                          1408), (0, 64), (64, 0), (0, 0)])
def test_gram_split_needs_rows_and_columns(m, n):
    assert kgram.gram_split(m, n, SMS) == 1


@pytest.mark.parametrize("m,n", MUON_SHAPES, ids=lambda v: str(v))
def test_gram_split_splits_zolomuon_shapes(m, n):
    s = kgram.gram_split(m, n, SMS)
    assert 1 < s <= kgram.GRAM_MAX_SLICES
    # every slice keeps its minimum of rows
    assert all(hi - lo >= kgram.GRAM_MIN_SLICE_ROWS // 2
               for lo, hi in _slices(m, s))


def test_gram_split_leaves_no_short_last_wave():
    """Where the most slices would add a second wave of a few blocks, the
    rule takes fewer: 4,096 x 1,024 (phase 19's K/V momenta) is 136 tile
    pairs, 1,088 blocks at S = 8 on 1,056 slots, 952 at S = 7."""
    assert kgram.gram_split(4096, 1024, SMS) == 7
    assert kgram.gram_split(2048, 1408, SMS) == 8  # 2,024: 1.9 waves
    slots = kgram.GRAM_RESIDENT[64] * SMS
    for m, n in _grid():
        s = kgram.gram_split(m, n, SMS)
        blocks = kgram.gram_pairs(n, 64) * s
        if s > 2:
            assert blocks <= slots or blocks % slots == 0 or \
                blocks % slots >= slots // 2, (m, n, s)


def _slices(m, s):
    """The row ranges [lo, hi) the kernel gives slices 0 .. s - 1."""
    rows = kgram.gram_slice_rows(m, s)
    return [(j * rows, min(m, (j + 1) * rows)) for j in range(s)]


def _grid():
    ms = [1, 15, 16, 17, 127, 128, 255, 256, 1000, 2047, 2048, 3352, 5000,
          12_288]
    ns = [1, 63, 64, 65, 127, 128, 129, 768, 1408, 1409, 2048, 2944, 4096]
    return list(itertools.product(ms, ns))


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_gram_split_slices_cover_m_once_in_order(sms):
    for m, n in _grid():
        s = kgram.gram_split(m, n, sms)
        assert 1 <= s <= kgram.GRAM_MAX_SLICES  # the cluster limit
        bounds = _slices(m, s)
        assert len(bounds) == s
        assert bounds[0][0] == 0 and bounds[-1][1] == m
        for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
            assert lo < hi == lo2  # contiguous, none empty
        rows = kgram.gram_slice_rows(m, s)
        assert rows % kgram.GRAM_CHUNK == 0  # whole chunks but the last
        assert all(hi - lo == rows for lo, hi in bounds[:-1])
        assert kgram.gram_tile(s) in (64, 128)


def test_gram_tile_is_narrow_where_m_is_split():
    assert kgram.gram_tile(1) == 128
    for m, n in MUON_SHAPES:  # 64-wide: also no masked 3/4 at n = 64
        assert kgram.gram_tile(kgram.gram_split(m, n, SMS)) == 64


def test_gram_f32_operand_reads_either_major_as_it_lies():
    a = torch.randn(40, 24)
    col = a.mT.contiguous().mT  # column-major, same values
    op, is_col, ld = kgram.gram_f32_operand(a, 1)
    assert op.data_ptr() == a.data_ptr() and not is_col and ld == 24
    for slices in (3, 1):  # split, or unsplit with float4 columns
        op, is_col, ld = kgram.gram_f32_operand(col, slices)
        assert op.data_ptr() == col.data_ptr() and is_col and ld == 40
    # a leading dimension of 41 (no float4 column): read in place where m
    # is split; unsplit, one row-major copy (faster on the card than the
    # kernel's scalar column loads)
    odd = torch.randn(24, 41).mT
    op, is_col, ld = kgram.gram_f32_operand(odd, 2)
    assert op.data_ptr() == odd.data_ptr() and is_col and ld == 41
    op, is_col, ld = kgram.gram_f32_operand(odd, 1)
    assert op.is_contiguous() and not is_col and ld == 24
    assert torch.equal(op, odd) and op.data_ptr() != odd.data_ptr()
    wide = torch.randn(24, 41)  # row-major, odd: in place (scalar loads)
    op, is_col, ld = kgram.gram_f32_operand(wide, 1)
    assert op.data_ptr() == wide.data_ptr() and not is_col and ld == 41
    with pytest.raises(ValueError, match="row-major or column-major"):
        kgram.gram_f32_operand(torch.randn(48, 40)[::2, ::2], 2)
    assert kgram.gram_layout(a) == "row" and kgram.gram_layout(col) == "col"


def test_combine_scalar_rule_by_value_or_pointer():
    cpu = torch.device("cpu")
    assert kcomb._scalar(0.5, cpu) == (None, 0.5)
    assert kcomb._scalar(2, cpu) == (None, 2.0)
    t = torch.tensor(0.25)
    buf, v = kcomb._scalar(t, cpu)
    assert buf is t and v == 0.0  # an f32 tensor on the device: as given
    buf, v = kcomb._scalar(torch.tensor([0.75], dtype=torch.float64), cpu)
    assert buf.dtype == torch.float32 and float(buf) == 0.75
    with pytest.raises(ValueError, match="one-element"):
        kcomb._scalar(torch.ones(2), cpu)


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the "
                    "card (python3 chip_smoke.py, or pytest -m gpu there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(2048, 1408), (1536, 768), (2048, 64),
                                 (2047, 1409), (2048, 1), (2048, 65),
                                 (4096, 1024), (300, 200), (301, 203),
                                 (5, 64)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("layout", ["row", "col"])
def test_gram_split_kernel_matches_plain(cuda, m, n, layout):
    gen = torch.Generator(device=cuda).manual_seed(22)
    a = torch.randn((m, n), generator=gen, device=cuda)
    if layout == "col":
        a = a.mT.contiguous().mT
    s = kgram.gram_split(m, n, kgram.device_sms(a.device))
    floor = 8.0 * torch.finfo(torch.float32).eps * float(
        torch.diagonal(ref.gram_ref(a)).amax())
    for c in (0.0, 4.0 * floor):
        before = (kgram.launches, dict(kgram.launches_by_split))
        got = ops.gram(a, c)
        again = ops.gram(a, c)
        assert kgram.launches == before[0] + 2
        assert kgram.launches_by_split.get(s, 0) == \
            before[1].get(s, 0) + 2
        want = ref.gram_ref(a, c)
        torch.cuda.synchronize()
        assert torch.equal(got, again)  # no float atomics
        assert torch.equal(got, got.mT)
        assert float((got - want).abs().amax()) <= \
            5e-5 * float(want.abs().amax())


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(0, 5), (5, 0), (0, 0)])
def test_gram_kernel_on_an_empty_a(cuda, m, n):
    a = torch.empty((m, n), device=cuda)
    before = kgram.launches
    got = ops.gram(a, 0.5)
    assert kgram.launches == before + 1
    assert torch.equal(got, 0.5 * torch.eye(n, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 1408), (2048, 64), (301, 77)])
@pytest.mark.parametrize("xw", ["number", "tensor"])
def test_combine_kernel_is_one_launch_a_call(cuda, shape, xw):
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn(shape, generator=gen, device=cuda)
    t = torch.randn((2,) + shape, generator=gen, device=cuda)
    a = torch.randn(2, generator=gen, device=cuda)
    mhat = torch.tensor(0.9, device=cuda)
    w = 0.5 if xw == "number" else torch.tensor(0.5, device=cuda)
    ops.grouped_combine(x, t, a, mhat, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = ops.grouped_combine(x, t, a, mhat, w)
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if getattr(e.device_type, "name", "") == "CUDA"]
    assert sum(e.count for e in on_card) == 1, [e.key for e in on_card]
    assert "combine" in on_card[0].key
    want = ref.grouped_combine_ref(x, t, a, mhat, w)
    assert float((got - want).abs().amax()) <= \
        1e-6 * float(want.abs().amax())
