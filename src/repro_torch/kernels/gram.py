"""K1: fused shifted Gram ``G = A^T A + c I`` — the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/gram.py::_gram_kernel``
(``gram_kernel_call``).  The kernel is ``csrc/gram.cu``; its plain PyTorch
version is :func:`gram_plain` (``ref.gram_ref``), which the CPU path runs
and the card is held against.

What bounds it on the H100: operations.  G is symmetric, so the function
needs m n (n + 1) f32 flops; at m = n = 11,999 that is 1.73 TFLOP, 26 ms
at 67 TFLOP/s (f32 outside the tensor cores), against 0.58 GB of input.
What the design does about it: a tiled SIMT kernel that computes only
the upper-triangle 128 x 128 tiles (mirroring the rest), with a
double-buffered shared-memory k loop and 8 x 8 f32 register tiles per
thread; true f32 products, no TF32.  A positive shift is clamped against
the *global* max diagonal by a one-block epilogue (the engine's
``_clamp_shift`` semantics; the Pallas kernel clamped per 256-wide tile,
which agrees only for n <= 256).

``launches`` counts kernel launches made through :func:`gram_kernel_call`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import gram_ref

gram_plain = gram_ref  # the plain PyTorch version of this kernel

GRAM_ACCUM_DTYPE = torch.float32
GRAM_INPUT_DTYPES = (torch.float32, torch.bfloat16)
# csrc/gram.cu bakes ref.SHIFT_RIDGE_FACTOR in as 8.0f * FLT_EPSILON

launches = 0


def gram_kernel_call(a: torch.Tensor, c=0.0) -> torch.Tensor:
    """Launch K1 on a CUDA tensor ``a`` (m, n), f32 or bf16, unit column
    stride.  Returns a new f32 (n, n) tensor.

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
    if n > 0 and m > 0 and (a.stride(1) != 1 or a.stride(0) < n):
        raise ValueError(f"gram kernel needs a row-major A (unit column "
                         f"stride), got strides {a.stride()}")
    if max(m, n) >= 2 ** 31:
        raise ValueError(f"gram kernel takes dims < 2^31, got {(m, n)}")
    g = torch.empty((n, n), dtype=GRAM_ACCUM_DTYPE, device=a.device)
    if isinstance(c, (int, float)) and c == 0:
        c_buf = None
    else:
        c_buf = torch.as_tensor(c, dtype=torch.float32,
                                device=a.device).reshape(1)
    lib = _build.library("gram")
    fn = lib.zolo_gram_f32 if a.dtype == torch.float32 else \
        lib.zolo_gram_bf16
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(a.data_ptr(), g.data_ptr(), m, n, max(a.stride(0), 1),
              None if c_buf is None else c_buf.data_ptr(), stream)
    _build.check(code, "gram kernel")
    launches += 1
    return g
