"""K3: tiled matmul ``C = alpha (A @ B)`` — the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/matmul.py::_matmul_kernel``
(``matmul_kernel_call``).  The kernel is ``csrc/matmul.cu``; its plain
PyTorch version is :func:`matmul_plain` (``ref.matmul_ref``), which the
CPU path runs and the card is held against.

K3 is off the solver path.  The reference's docstring names Q1 Q2^T,
U = Q_p V and the formation of H as its users, but its code computes all
three with ``jnp`` (``core/zolo.py``, ``core/qdwh.py::form_h``,
``solver/planner.py``); only ``repro.kernels.ops.matmul`` reaches the
kernel.  The port keeps the same split: its solver leaves those products
to ``torch.matmul``, and K3 is reached through
:func:`repro_torch.kernels.ops.matmul` alone.

What bounds it on the H100: operations.  2 m n k f32 flops, 3.46 TFLOP at
m = n = k = 11,999: 51.6 ms at 67 TFLOP/s (f32 outside the tensor cores).
What the design does about it: 128 x 128 output tiles of 256 threads
with 8 x 8 f32 register tiles, a double-buffered 16-deep k loop in shared
memory, loads along whichever axis of each operand has unit stride, and
masked ragged edges (any m, k, n; no padding).  True f32 products, no
TF32; bf16 operands widen to f32 per element.

``launches`` counts kernel launches made through :func:`matmul_kernel_call`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import matmul_ref

matmul_plain = matmul_ref  # the plain PyTorch version of this kernel

MATMUL_ACCUM_DTYPE = torch.float32
MATMUL_INPUT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_DIM = 65_535 * 128  # grid rows of 128-wide tiles

launches = 0


def matmul_kernel_call(a: torch.Tensor, b: torch.Tensor,
                       alpha=1.0) -> torch.Tensor:
    """Launch K3 on CUDA tensors ``a`` (m, k) and ``b`` (k, n), each f32
    or bf16, any strides.  Returns a new row-major f32 (m, n) tensor.

    ``alpha`` is a python number or a one-element tensor on the operands'
    device (read by the kernel, so the host never syncs on it).  Raises on
    any dtype, shape or device the kernel does not take."""
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul kernel takes CUDA tensors on one device, "
                         f"got a on {a.device}, b on {b.device}")
    if a.dtype not in MATMUL_INPUT_DTYPES or \
            b.dtype not in MATMUL_INPUT_DTYPES:
        raise ValueError(f"matmul kernel takes {MATMUL_INPUT_DTYPES}, got "
                         f"a {a.dtype}, b {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul kernel takes (m, k) @ (k, n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n) > _MAX_DIM or k >= 2 ** 31:
        raise ValueError(f"matmul kernel takes m, n <= {_MAX_DIM} and "
                         f"k < 2^31, got {(m, k, n)}")
    if isinstance(alpha, torch.Tensor):
        alpha_buf = alpha.to(device=a.device, dtype=torch.float32)
        if alpha_buf.numel() != 1:
            raise ValueError(f"matmul kernel takes one alpha, got "
                             f"{alpha_buf.numel()}")
        alpha_buf = alpha_buf.reshape(1)
        alpha_val = 0.0
    else:
        alpha_buf = None
        alpha_val = float(alpha)
    c = torch.empty((m, n), dtype=MATMUL_ACCUM_DTYPE, device=a.device)
    lib = _build.library("matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.zolo_matmul(
        int(a.dtype == torch.bfloat16), int(b.dtype == torch.bfloat16),
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
        a.stride(1), b.stride(0), b.stride(1), alpha_val,
        None if alpha_buf is None else alpha_buf.data_ptr(), stream)
    _build.check(code, "matmul kernel")
    launches += 1
    return c
