"""Routes of the port's tensor-core kernels: K1 (fused shifted Gram), K3
(tiled matmul) and K4 (causal flash attention) each have a ``"wgmma"``
route (TMA + ``wgmma``, bf16) and a ``"simt"`` route (FFMA, every other
input).

On the CPU: the route rules, which read dtypes, shapes, strides and data
pointers only (so CPU tensors stand in for CUDA ones), the bf16 staging
helper that gives TMA a leading dimension it can describe (K1 stages an
operand at most once, keeping its major), the solver's K1 bundle handing
bf16 operands over uncopied, and the build's rebuild rule for the shared
``csrc/*.cuh`` header.  No ``nvcc`` is needed.

The ``gpu``-marked tests launch each route on the card and hold it against
the plain version with the bounds of ``tests/test_torch_kernels.py``
(K1 bf16: m eps (|A|^T |A|) elementwise, G exactly symmetric; K3:
k eps |alpha| (|A| @ |B|) elementwise; K4 bf16: 2^-8 (P|V| + |o|) plus
1e-5 max|v|; K4 f32: 1e-5 max|v|), reading each route's launch counter
around its own call.  On the card:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_hopper.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.core import zolo_cuda  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import gram as kgram  # noqa: E402
from repro_torch.kernels import matmul as kmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32


def _misaligned(shape, dtype):
    """A tensor of ``shape`` whose base is 2 bytes past a 16-byte
    boundary (row-major, contiguous strides)."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=dtype)
    off = (-(flat.data_ptr() // flat.element_size()) + 1) % 8
    return flat[off:off + n].view(shape)


# --- K1 route and layout rules -----------------------------------------------


@pytest.mark.parametrize("dtype,shape,want", [
    (BF, (24, 40), "wgmma"),
    (BF, (1, 1), "wgmma"),
    (BF, (11_999, 3), "wgmma"),
    (BF, (0, 16), "simt"),     # nothing to load: G = c I
    (BF, (16, 0), "simt"),
    (F32, (24, 40), "simt"),
])
def test_gram_route_by_dtype_and_shape(dtype, shape, want):
    assert kgram.gram_route(torch.zeros(shape, dtype=dtype)) == want
    # the rule reads the dtype and shape, not the layout
    assert kgram.gram_route(torch.zeros(shape[::-1], dtype=dtype).mT) == \
        want


@pytest.mark.parametrize("case,col,staged", [
    ("row-major aligned", False, False),
    ("column-major aligned", True, False),
    ("rows of 11,999", False, True),
    ("column-major, columns of 11,999", True, True),
    ("misaligned base", False, True),
    ("strided both ways", False, True),
])
def test_gram_operand_reads_as_it_lies_or_stages_once(case, col, staged,
                                                      monkeypatch):
    t = {
        "row-major aligned": lambda: torch.randn(40, 24).to(BF),
        "column-major aligned": lambda: torch.randn(24, 40).to(BF).mT,
        "rows of 11,999": lambda: torch.randn(3, 11_999).to(BF),
        "column-major, columns of 11,999": lambda: torch.randn(
            5, 11_999).to(BF).mT,
        "misaligned base": lambda: _misaligned((16, 24), BF),
        "strided both ways": lambda: torch.randn(32, 48).to(BF)[::2, ::2],
    }[case]()
    copies = []

    def counted(x):
        copies.append(tuple(x.shape))
        return kmm.stage_bf16(x)

    monkeypatch.setattr(kgram, "stage_bf16", counted)
    op, is_col, ld = kgram.gram_operand(t)
    assert is_col == col
    assert len(copies) == int(staged)
    assert op.shape == t.shape and torch.equal(op, t)
    assert ld % 8 == 0 and op.data_ptr() % 16 == 0
    assert kmm.tma_layout(op) == ("col" if col else "row", ld)
    assert (op.data_ptr() != t.data_ptr()) == staged
    if staged and col:  # the staged copy keeps the column-major layout: no transpose
        assert op.stride(0) == 1 and copies == [tuple(t.mT.shape)]


def test_zolo_cuda_bundle_copies_only_f32_operands(monkeypatch):
    """The solver's K1 bundle hands an operand of either major to K1 as it
    lies, bf16 or f32 (K1 stages a bf16 one at most once and reads an f32
    one in place); only an f32 operand of other strides is made row-major
    here, as K1's f32 route needs."""
    seen = []

    def fake_gram(x, c=0.0):
        seen.append(x)
        return ref.gram_ref(x, c)

    monkeypatch.setattr(zolo_cuda._kops, "gram", fake_gram)
    ops_ = zolo_cuda.cuda_zolo_ops()
    q1t = torch.randn(2, 24, 40)  # (r, n, m): a solve result, read as .mT
    for dt in (BF, F32):
        seen.clear()
        x = q1t.mT.to(dt)
        g = ops_.gram(x)
        assert g.shape == (2, 24, 24)
        for j, op in enumerate(seen):
            assert torch.equal(op, x[j])
            assert op.data_ptr() == x[j].data_ptr()
    seen.clear()
    strided = torch.randn(48, 40)[::2, ::2]  # neither major
    ops_.gram(strided)
    assert seen[0].is_contiguous() and torch.equal(seen[0], strided)


# --- K3 route rule -----------------------------------------------------------


@pytest.mark.parametrize("adt,bdt,k,want", [
    (BF, BF, 64, "wgmma"),
    (BF, BF, 13, "wgmma"),     # any k >= 1: TMA zero-fills the k tail
    (BF, BF, 0, "simt"),       # nothing to load: the f32 kernel writes 0
    (BF, F32, 64, "simt"),     # mixed: never rounds the f32 operand
    (F32, BF, 64, "simt"),
    (F32, F32, 64, "simt"),
])
def test_matmul_route_by_dtype_and_k(adt, bdt, k, want):
    a = torch.zeros((24, k), dtype=adt)
    b = torch.zeros((k, 40), dtype=bdt)
    assert kmm.matmul_route(a, b) == want


@pytest.mark.parametrize("case,want", [
    ("row aligned", ("row", 24)),
    ("row padded", ("row", 32)),
    ("transposed aligned", ("col", 16)),
    ("row unaligned ld", None),          # 11,999-like rows: staged
    ("transposed unaligned ld", None),
    ("misaligned base", None),
    ("strided both ways", None),
    ("broadcast rows", None),
])
def test_tma_layout_reads_strides_and_alignment(case, want):
    t = {
        "row aligned": lambda: torch.zeros((16, 24), dtype=BF),
        "row padded": lambda: torch.zeros((16, 32), dtype=BF)[:, :21],
        "transposed aligned": lambda: torch.zeros((24, 16), dtype=BF).mT,
        "row unaligned ld": lambda: torch.zeros((16, 13), dtype=BF),
        "transposed unaligned ld": lambda: torch.zeros((16, 13),
                                                       dtype=BF).mT,
        "misaligned base": lambda: _misaligned((16, 24), BF),
        "strided both ways": lambda: torch.zeros((32, 48), dtype=BF)[::2,
                                                                      ::2],
        "broadcast rows": lambda: torch.zeros((1, 24), dtype=BF).expand(16,
                                                                        24),
    }[case]()
    assert kmm.tma_layout(t) == want


@pytest.mark.parametrize("make", [
    lambda: torch.arange(5 * 13, dtype=F32).view(5, 13),
    lambda: torch.arange(13 * 5, dtype=F32).view(13, 5).mT,
    lambda: torch.arange(3 * 8, dtype=F32).view(3, 8),
    lambda: torch.arange(1 * 7, dtype=F32).view(1, 7),
], ids=["ragged", "transposed", "aligned", "one-row"])
def test_stage_bf16_keeps_values_and_pads_the_stride(make):
    src = make().to(BF)
    staged = kmm.stage_bf16(src)
    assert staged.shape == src.shape and staged.dtype == BF
    assert torch.equal(staged, src)
    ld = staged.stride(0)
    assert staged.stride(1) == 1
    assert ld % 8 == 0 and src.shape[1] <= ld < src.shape[1] + 8
    assert kmm.tma_layout(staged) == ("row", ld)


# --- K4 route rule -----------------------------------------------------------


def _bshd(shape, dtype=BF, layout="bshd", hd_pad=0):
    b, s, h, d = shape
    if layout == "bhsd":  # (b, h, s, d) storage seen as (b, s, h, d)
        return torch.zeros((b, h, s, d), dtype=dtype).transpose(1, 2)
    if hd_pad:  # heads hd_pad elements apart past d
        return torch.zeros((b, s, h, d + hd_pad), dtype=dtype)[..., :d]
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case,want", [
    ("bf16 d=128", "wgmma"),
    ("bf16 d=64", "wgmma"),
    ("bf16 d=128 (b, h, s, d) view", "wgmma"),
    ("bf16 d=64 heads padded by 8", "wgmma"),
    ("f32 d=128", "simt"),
    ("bf16 d=32", "simt"),
    ("bf16 d=120", "simt"),
    ("bf16 d=128 heads padded by 4", "simt"),   # head stride % 8 != 0
    ("bf16 d=64 (b, h, s, d) view, rows of 68", "simt"),  # s stride 68
    ("bf16 d=128 misaligned base", "simt"),
    ("bf16 d=64 strided d", "simt"),
])
def test_flash_route_reads_dtype_d_strides_and_alignment(case, want):
    q = {
        "bf16 d=128": lambda: _bshd((1, 40, 2, 128)),
        "bf16 d=64": lambda: _bshd((2, 33, 3, 64)),
        "bf16 d=128 (b, h, s, d) view": lambda: _bshd((1, 40, 2, 128),
                                                      layout="bhsd"),
        "bf16 d=64 heads padded by 8": lambda: _bshd((1, 40, 2, 64),
                                                     hd_pad=8),
        "f32 d=128": lambda: _bshd((1, 40, 2, 128), dtype=F32),
        "bf16 d=32": lambda: _bshd((1, 40, 2, 32)),
        "bf16 d=120": lambda: _bshd((1, 40, 2, 120)),
        "bf16 d=128 heads padded by 4": lambda: _bshd((1, 40, 2, 128),
                                                      hd_pad=4),
        "bf16 d=64 (b, h, s, d) view, rows of 68": lambda: torch.zeros(
            (1, 2, 40, 68), dtype=BF)[..., :64].transpose(1, 2),
        "bf16 d=128 misaligned base": lambda: _misaligned((1, 40, 2, 128),
                                                          BF),
        "bf16 d=64 strided d": lambda: torch.zeros((1, 40, 2, 128),
                                                   dtype=BF)[..., ::2],
    }[case]()
    k = torch.zeros(q.shape, dtype=q.dtype)
    assert kflash.flash_route(q, k, k) == want
    # the rule looks at every operand, not q alone
    if want == "wgmma":
        assert kflash.flash_route(k, k, q) == "wgmma"
        assert kflash.flash_route(k, _misaligned(tuple(q.shape), BF),
                                  k) == "simt"


# --- build: the shared header ------------------------------------------------


def test_build_target_tracks_every_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "x.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// v1\n")
    first = build._target("x")
    assert first == build._target("x")  # deterministic
    (tmp_path / "a.cuh").write_text("// v2\n")
    second = build._target("x")
    assert second != first
    (tmp_path / "b.cuh").write_text("// new\n")
    third = build._target("x")
    assert third not in (first, second)
    (tmp_path / "x.cu").write_text('#include "a.cuh"\n// edited\n')
    assert build._target("x") not in (first, second, third)


def test_build_header_is_included_by_the_tensor_core_sources():
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert headers == {"hopper.cuh"}
    for name in ("gram", "matmul", "flash_attention"):
        assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu"
                                           ).read_text()
    text = (build.CSRC / "hopper.cuh").read_text()
    for piece in ("cuTensorMapEncodeTiled", "cudaGetDriverEntryPoint",
                  "CU_TENSOR_MAP_SWIZZLE_128B", "mbarrier.try_wait.parity",
                  "mbarrier.arrive.expect_tx", "cp.async.bulk.tensor",
                  "wgmma.fence", "wgmma.commit_group", "wgmma.wait_group",
                  "m64n256k16.f32.bf16.bf16", "m64n128k16.f32.bf16.bf16"):
        assert piece in text, piece


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the "
                    "card (python3 chip_smoke.py, or pytest -m gpu there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _route_call(mod, route, fn):
    """fn() with the launch counters read around it: exactly one launch,
    on ``route``."""
    before = dict(mod.launches_by_route)
    total = mod.launches
    out = fn()
    after = mod.launches_by_route
    assert mod.launches == total + 1
    assert {r: after[r] - before[r] for r in after} == \
        {r: int(r == route) for r in after}
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case,route", [
    ("bf16 row (256, 512) @ (512, 264)", "wgmma"),
    ("bf16 transposed views (384, 256) @ (256, 320)", "wgmma"),
    ("bf16 staged (1001, 333) @ (333, 517)", "wgmma"),
    ("bf16 A transposed, B staged (200, 136) @ (136, 77)", "wgmma"),
    ("bf16/f32 (300, 129) @ (129, 200)", "simt"),
    ("f32 (1001, 333) @ (333, 517)", "simt"),
    ("f32 transposed (257, 100) @ (100, 129)", "simt"),
])
def test_matmul_route_matches_plain(cuda, case, route):
    gen = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*shape, dt=BF):
        return torch.randn(shape, generator=gen, device=cuda).to(dt)

    a, b = {
        "bf16 row (256, 512) @ (512, 264)": lambda: (rnd(256, 512),
                                                     rnd(512, 264)),
        "bf16 transposed views (384, 256) @ (256, 320)": lambda: (
            rnd(256, 384).mT, rnd(320, 256).mT),
        "bf16 staged (1001, 333) @ (333, 517)": lambda: (rnd(1001, 333),
                                                         rnd(333, 517)),
        "bf16 A transposed, B staged (200, 136) @ (136, 77)": lambda: (
            rnd(136, 200).mT, rnd(136, 77)),
        "bf16/f32 (300, 129) @ (129, 200)": lambda: (rnd(300, 129),
                                                     rnd(129, 200, dt=F32)),
        "f32 (1001, 333) @ (333, 517)": lambda: (rnd(1001, 333, dt=F32),
                                                 rnd(333, 517, dt=F32)),
        "f32 transposed (257, 100) @ (100, 129)": lambda: (
            rnd(100, 257, dt=F32).mT, rnd(129, 100, dt=F32).mT),
    }[case]()
    for alpha in (1.5, torch.tensor(-0.5, device=cuda)):
        got = _route_call(kmm, route, lambda: ops.matmul(a, b, alpha))
        want = ref.matmul_ref(a, b, alpha)
        torch.cuda.synchronize()
        assert got.dtype == F32 and got.shape == (a.shape[0], b.shape[1])
        k = a.shape[1]
        bound = (k * torch.finfo(F32).eps * abs(float(alpha))
                 * (a.float().abs() @ b.float().abs()))
        assert bool(((got - want).abs() <= bound + 1e-30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50, 17), (17, 50), (40, 300),
                                   (300, 200), (1000, 333), (129, 257),
                                   (64, 256), (260, 384)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layout", ["row", "col", "col aligned"])
@pytest.mark.parametrize("shift", ["none", "zero", "below_floor",
                                   "above_floor"])
def test_gram_wgmma_route_matches_plain(cuda, shape, layout, shift):
    """Ragged m and n below one tile, n not a multiple of 64, m < 64, both
    majors (staged and as they lie), every shift case; one launch a call,
    on the wgmma route."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    m, n = shape
    if layout == "row":
        a = torch.randn((m, n), generator=gen, device=cuda).to(BF)
    elif layout == "col":
        a = torch.randn((n, m), generator=gen, device=cuda).to(BF).mT
    else:  # column-major with a leading dimension padded to 8: zero-copy
        ld = -(-m // 8) * 8
        a = torch.randn((n, ld), generator=gen, device=cuda).to(BF)
        a = a[:, :m].mT
    floor = 8.0 * torch.finfo(F32).eps * float(
        torch.diagonal(ref.gram_ref(a)).amax())
    c = {"none": 0.0, "zero": torch.zeros((), device=cuda),
         "below_floor": 0.25 * floor, "above_floor": 4.0 * floor}[shift]
    got = _route_call(kgram, "wgmma", lambda: ops.gram(a, c))
    want = ref.gram_ref(a, c)
    torch.cuda.synchronize()
    assert got.dtype == F32 and got.shape == (n, n)
    assert torch.equal(got, got.mT)
    absa = a.float().abs()
    bound = m * torch.finfo(F32).eps * (absa.mT @ absa)
    assert bool(((got - want).abs() <= bound + 1e-30).all())
    if shift in ("below_floor", "above_floor"):
        applied = (torch.diagonal(got).double()
                   - torch.diagonal(ops.gram(a)).double()).mean().item()
        assert applied == pytest.approx(max(c, floor), rel=0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32 (300, 200)", "f32 (1000, 333)",
                                  "bf16 empty (0, 40)"])
def test_gram_simt_route_matches_plain(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = {"f32 (300, 200)": lambda: torch.randn((300, 200), generator=gen,
                                               device=cuda),
         "f32 (1000, 333)": lambda: torch.randn((1000, 333), generator=gen,
                                                device=cuda),
         "bf16 empty (0, 40)": lambda: torch.zeros((0, 40), dtype=BF,
                                                   device=cuda)}[case]()
    for c in (0.0, 0.5):
        got = _route_call(kgram, "simt", lambda: ops.gram(a, c))
        want = ref.gram_ref(a, c)
        torch.cuda.synchronize()
        assert torch.equal(got, got.mT)
        assert float((got - want).abs().amax()) <= \
            5e-5 * max(float(want.abs().amax()), 1e-30)


def _flash_bound(q, k, v, want):
    u = 2.0 ** -8
    pv = ref.flash_attention_ref(q, k, v.abs())
    return ((u + u * u) * pv + u * want.abs()
            + 1e-5 * float(v.float().abs().amax()))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 100, 300, 512])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_wgmma_route_matches_plain(cuda, d, s, layout):
    gen = torch.Generator(device=cuda).manual_seed(8)
    b, h = 2, 3

    def rnd():
        if layout == "bhsd":
            return torch.randn((b, h, s, d), generator=gen,
                               device=cuda).to(BF).transpose(1, 2)
        return torch.randn((b, s, h, d), generator=gen, device=cuda).to(BF)

    q, k, v = rnd(), rnd(), rnd()
    got = _route_call(kflash, "wgmma", lambda: ops.flash_attention(q, k, v))
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == BF and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want).abs()
    assert bool((diff <= _flash_bound(q, k, v, want)).all()), \
        float((diff / _flash_bound(q, k, v, want)).amax())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(F32, 128), (F32, 64), (BF, 32),
                                     (BF, 120)])
def test_flash_simt_route_matches_plain(cuda, dtype, d):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((1, 200, 2, d), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    got = _route_call(kflash, "simt", lambda: ops.flash_attention(q, k, v))
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs()
    if dtype == F32:
        assert float(diff.amax()) <= 1e-5 * float(v.abs().amax())
    else:
        assert bool((diff <= _flash_bound(q, k, v, want)).all())
