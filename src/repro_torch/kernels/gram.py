"""K1: fused shifted Gram ``G = A^T A + c I`` — the CUDA kernels' wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/gram.py::_gram_kernel``
(``gram_kernel_call``).  The kernels are in ``csrc/gram.cu``; their plain
PyTorch version is :func:`gram_plain` (``ref.gram_ref``), which the CPU
path runs and the card is held against.

Two routes, chosen by :func:`gram_route` from A's dtype and shape before
the launch (a rule, not a fallback on failure):

* ``"wgmma"`` — bf16 A with m, n >= 1: TMA + ``wgmma`` on the tensor
  cores, bf16 products summed in f32, 128 x 256 tiles of the upper
  triangle only.  Bound on the H100: operations, m n (n + 1) flops at 989
  TFLOP/s (1.75 ms at 11,999^2).  TMA reads A as it lies, row-major or
  column-major (the solver's Q1 arrives as a transposed view), when its
  leading dimension is a multiple of 8 elements and its base is 16-byte
  aligned; any other A is staged once by :func:`gram_operand` into a
  buffer whose leading dimension is padded (its major kept, so the copy
  never transposes).  The tensor map keeps the true extent, so the pad is
  never read.
* ``"simt"`` — every other A (f32, or an empty bf16 one, widened
  exactly): true f32 FFMA products (no TF32), tiles of the upper
  triangle, one kernel for every shape and either major.  Bound: m n (n +
  1) flops at 67 TFLOP/s (26 ms at 11,999^2).  :func:`gram_split` (a rule
  of the shape and the SM count, read once per device) splits the
  reduction over m into S <= 8 slices where G's upper triangle alone
  would leave the card under two resident waves of tiles (ZoloMuon's n <=
  ~2,900), on 64-wide tiles, which also fit a narrow G (n = 64); the S
  blocks of a tile form a thread-block cluster and sum their partial
  tiles in slice order over distributed shared memory, so G is bitwise
  repeatable (no float atomics).  Where S = 1 (the large solves, a
  short m) the tiles are 128 wide.  A is read as it lies, row-major or
  column-major (the CholeskyQR2 second pass's Q1 and Q2 are transposed
  views), as float4s where its leading dimension and base allow, else as
  scalars; a column-major A with no float4 columns is copied row-major
  once where S = 1 (:func:`gram_f32_operand`); any other strides raise.

Both write G exactly symmetric (each off-diagonal value computed once and
mirrored).  A positive shift is clamped against the *global* max
diagonal by a one-block epilogue (the engine's ``_clamp_shift``
semantics; the Pallas kernel clamped per 256-wide tile, which agrees only
for n <= 256).

``launches`` counts kernel launches made through :func:`gram_kernel_call`,
``launches_by_route`` splits them by route and ``launches_by_split`` the
``"simt"`` ones by S (the shift epilogue is not counted).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.matmul import stage_bf16, tma_layout
from repro_torch.kernels.ref import gram_ref

gram_plain = gram_ref  # the plain PyTorch version of this kernel

# accumulation dtype of the kernel's sums, and where the conditioning
# envelope measured at it lives (kernel-accum-envelope lint)
GRAM_ACCUM_DTYPE = torch.float32
GRAM_KAPPA_ENVELOPE = "repro_torch.core.svd:CUDA_KAPPA_ENVELOPE"
GRAM_INPUT_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("simt", "wgmma")
# csrc/gram.cu bakes ref.SHIFT_RIDGE_FACTOR in as 8.0f * FLT_EPSILON

# the split rule's constants (csrc/gram.cu: kChunk, kMaxCluster and the
# launch bounds of gram_slices)
GRAM_CHUNK = 16             # rows of A a pipeline stage
GRAM_MAX_SLICES = 8         # a portable cluster: the slices of one tile
GRAM_MIN_SLICE_ROWS = 128   # 8 chunks: a slice's pipeline fill <= 1/8 of it
GRAM_RESIDENT = {128: 2, 64: 8}  # blocks an SM holds (256 / 64 threads)
GRAM_WAVES = 2              # split only below this many resident waves

launches = 0
launches_by_route = {r: 0 for r in ROUTES}
launches_by_split = {}  # {S: "simt" launches with S slices}
_SMS = {}  # device index -> SM count, read once


def device_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, read once."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return sms


def gram_pairs(n: int, tile: int) -> int:
    """Tiles of G's upper triangle (diagonal ones included)."""
    t = -(-n // tile)
    return t * (t + 1) // 2


def gram_tile(slices: int) -> int:
    """The ``"simt"`` kernel's tile edge: 64 where m is split (a 64-wide
    tile also fits a narrow G, n <= 64), 128 where it is not."""
    return 128 if slices == 1 else 64


def gram_split(m: int, n: int, sms: int) -> int:
    """S, the slices of m that each tile of the ``"simt"`` route sums
    over (1: no split).  A rule of the shape and the SM count alone:

    * S = 1 for an empty A, for m below two slices of
      ``GRAM_MIN_SLICE_ROWS``, and where the upper triangle holds
      ``GRAM_WAVES`` resident waves of 128-wide tiles or more (n >= 4,096
      on 132 SMs: the large solves);
    * else 64-wide tiles, and S = 2 where two slices of them give every SM
      at least half the blocks it holds (n >= 1,409 on 132 SMs);
    * else the most slices the rows allow (<= 8) whose blocks fit one
      resident wave or fill the last of their waves at least half: a
      second wave of a few blocks would run alone on an idle card
      (4,096 x 1,024 takes 7 slices, 952 blocks on 1,056 slots, not 8,
      1,088);
    * then the fewest slices of whole 16-row chunks that give every slice
      the same number of chunks but the last (no slice is empty).

    Clusters of more than two blocks are placed on the card's GPCs
    unevenly, so the wave count alone does not tell which S is fastest;
    these branches are what a sweep of S = 1..8 on an H100 found fastest,
    or within 4% of it, at the shapes it swept (``chip_ab.py``, PERF.md):
    ZoloMuon's 2,048 x 1,408, 2,048^2, 2,048 x 64, 3,352 x 768, 1,536 x
    768 and 4,096 x 1,024, and 2,048 x 2,944.  Elsewhere the choice is not
    measured.
    """
    top = min(GRAM_MAX_SLICES, m // GRAM_MIN_SLICE_ROWS)
    if n <= 0 or top < 2:
        return 1
    if gram_pairs(n, 128) >= GRAM_WAVES * GRAM_RESIDENT[128] * sms:
        return 1
    pairs = gram_pairs(n, 64)
    slots = GRAM_RESIDENT[64] * sms
    best = 2 if 2 * pairs >= slots // 2 else top
    while best > 2 and pairs * best > slots and \
            0 < pairs * best % slots < slots // 2:
        best -= 1
    chunks = -(-m // GRAM_CHUNK)
    per = -(-chunks // best)
    return -(-chunks // per)


@functools.lru_cache(maxsize=1024)
def _simt_plan(m: int, n: int, sms: int) -> Tuple[int, int, int]:
    """(S, tile, rows a slice) of the ``"simt"`` route at (m, n)."""
    slices = gram_split(m, n, sms)
    return slices, gram_tile(slices), gram_slice_rows(m, slices)


def gram_slice_rows(m: int, slices: int) -> int:
    """Rows of every slice but the last: whole 16-row chunks, at least one
    (slice s is rows [s rows, min(m, (s + 1) rows)), as the kernel cuts
    them)."""
    chunks = -(-m // GRAM_CHUNK)
    return max(-(-chunks // slices), 1) * GRAM_CHUNK


def gram_layout(a: torch.Tensor) -> Optional[str]:
    """``"row"`` (unit column stride), ``"col"`` (unit row stride) or
    None: the strides K1's f32 route reads."""
    m, n = a.shape
    if a.stride(1) == 1 and a.stride(0) >= n:
        return "row"
    if a.stride(0) == 1 and a.stride(1) >= m:
        return "col"
    return None


def gram_f32_operand(a: torch.Tensor,
                     slices: int) -> Tuple[torch.Tensor, bool, int]:
    """K1's layout rule for the ``"simt"`` route: (operand, column-major,
    leading dimension).  A row-major f32 ``a`` is taken as it lies (the
    kernel loads float4s where the leading dimension is a multiple of 4
    and the base 16-byte aligned, scalars elsewhere: n = 11,999).  A
    column-major one is read in place, but for S = 1 with no float4
    columns (the 11,999^2 solve's second-pass Grams), where it is copied
    row-major once: on an H100 the kernel's scalar column loads made it
    3.7% slower than the copy and the row-major read (PERF.md, PR 22).
    Any other strides raise."""
    lay = gram_layout(a)
    if lay is None:
        raise ValueError(f"gram kernel needs a row-major or column-major "
                         f"f32 A, got strides {a.stride()}")
    if lay == "col" and slices == 1 and (a.stride(1) % 4
                                         or a.data_ptr() % 16):
        a, lay = a.contiguous(), "row"
    col = lay == "col"
    return a, col, a.stride(1) if col else a.stride(0)


def gram_resident(tile: int, col: bool = False) -> int:
    """Blocks of the split kernel one SM of the current card holds (on
    the card only): what ``GRAM_RESIDENT`` assumes."""
    blocks = ctypes.c_int(0)
    code = _build.library("gram").zolo_gram_f32_resident(
        tile, int(col), ctypes.byref(blocks))
    _build.check(code, "gram kernel occupancy")
    return blocks.value


def gram_route(a: torch.Tensor) -> str:
    """The route of ``a^T a``: ``"wgmma"`` for a bf16 ``a`` with m, n >= 1,
    else ``"simt"``.  Reads the dtype and shape only."""
    if a.dtype == torch.bfloat16 and a.ndim == 2 and min(a.shape) >= 1:
        return "wgmma"
    return "simt"


def gram_operand(a: torch.Tensor) -> Tuple[torch.Tensor, bool, int]:
    """K1's layout rule for the ``"wgmma"`` route: (operand, column-major,
    leading dimension).  A bf16 ``a`` that TMA can read as it lies
    (:func:`~repro_torch.kernels.matmul.tma_layout`) is returned itself;
    any other is copied once by :func:`stage_bf16` — a column-major one as
    its transpose, so it stays column-major and the copy is a plain one."""
    lay = tma_layout(a)
    if lay is not None:
        return a, lay[0] == "col", lay[1]
    if a.stride(0) == 1 and a.stride(1) != 1:
        staged = stage_bf16(a.mT).mT
        return staged, True, staged.stride(1)
    staged = stage_bf16(a)
    return staged, False, staged.stride(0)


def gram_kernel_call(a: torch.Tensor, c=0.0) -> torch.Tensor:
    """Launch K1 on a CUDA tensor ``a`` (m, n): bf16 of any strides, or f32
    row-major or column-major.  Returns a new f32 (n, n) tensor.

    ``c`` is a python number or a one-element tensor on ``a``'s device; a
    python ``0`` adds no shift (and skips the epilogue).  Raises on any
    dtype, shape, layout or device the kernel does not take."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"gram kernel takes a CUDA tensor, got {a.device}")
    if a.dtype not in GRAM_INPUT_DTYPES:
        raise ValueError(f"gram kernel takes {GRAM_INPUT_DTYPES}, got "
                         f"{a.dtype}")
    if a.ndim != 2:
        raise ValueError(f"gram kernel takes one (m, n) matrix, got shape "
                         f"{tuple(a.shape)}")
    m, n = a.shape
    if max(m, n) >= 2 ** 31:
        raise ValueError(f"gram kernel takes dims < 2^31, got {(m, n)}")
    route = gram_route(a)
    slices = 1
    if route == "simt":
        if a.dtype != torch.float32:
            a = a.float()  # an empty bf16 A: nothing to round
        slices, tile, rows = _simt_plan(m, n, device_sms(a.device))
        a, col, lda = gram_f32_operand(a, slices) if m > 0 and n > 0 \
            else (a, False, n)
    g = a.new_empty((n, n), dtype=GRAM_ACCUM_DTYPE)
    if isinstance(c, (int, float)) and c == 0:
        c_buf = None
    else:
        c_buf = torch.as_tensor(c, dtype=torch.float32,
                                device=a.device).reshape(1)
    c_ptr = None if c_buf is None else c_buf.data_ptr()
    lib = _build.library("gram")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if route == "wgmma":
        op, col, ld = gram_operand(a)
        code = lib.zolo_gram_bf16_wgmma(op.data_ptr(), int(col), ld,
                                        g.data_ptr(), m, n, c_ptr, stream)
    else:
        code = lib.zolo_gram_f32_split(a.data_ptr(), int(col), lda,
                                       g.data_ptr(), m, n, tile, slices,
                                       rows, c_ptr, stream)
    _build.check(code, f"gram kernel ({route})")
    launches += 1
    launches_by_route[route] += 1
    if route == "simt":
        launches_by_split[slices] = launches_by_split.get(slices, 0) + 1
    return g
