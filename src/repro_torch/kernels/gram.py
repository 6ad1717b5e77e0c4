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
  exactly): true f32 FFMA products (no TF32), 128 x 128 tiles of the
  upper triangle.  Bound: m n (n + 1) flops at 67 TFLOP/s (26 ms at
  11,999^2).  Needs a row-major A.

Both write G exactly symmetric (each off-diagonal value computed once and
mirrored).  A positive shift is clamped against the *global* max
diagonal by a one-block epilogue (the engine's ``_clamp_shift``
semantics; the Pallas kernel clamped per 256-wide tile, which agrees only
for n <= 256).

``launches`` counts kernel launches made through :func:`gram_kernel_call`,
and ``launches_by_route`` splits them by route.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.matmul import stage_bf16, tma_layout
from repro_torch.kernels.ref import gram_ref

gram_plain = gram_ref  # the plain PyTorch version of this kernel

GRAM_ACCUM_DTYPE = torch.float32
GRAM_INPUT_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("simt", "wgmma")
# csrc/gram.cu bakes ref.SHIFT_RIDGE_FACTOR in as 8.0f * FLT_EPSILON

launches = 0
launches_by_route = {r: 0 for r in ROUTES}


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
    with unit column stride.  Returns a new f32 (n, n) tensor.

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
    if route == "simt":
        a = a.float()  # an empty bf16 A: nothing to round
        if n > 0 and m > 0 and (a.stride(1) != 1 or a.stride(0) < n):
            raise ValueError(f"gram kernel needs a row-major f32 A (unit "
                             f"column stride), got strides {a.stride()}")
    g = torch.empty((n, n), dtype=GRAM_ACCUM_DTYPE, device=a.device)
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
        code = lib.zolo_gram_f32(a.data_ptr(), g.data_ptr(), m, n,
                                 max(a.stride(0), 1), c_ptr, stream)
    _build.check(code, f"gram kernel ({route})")
    launches += 1
    launches_by_route[route] += 1
    return g
