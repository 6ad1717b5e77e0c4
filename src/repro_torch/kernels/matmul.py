"""K3: tiled matmul ``C = alpha (A @ B)`` — the CUDA kernels' wrapper.

Replaces the Pallas TPU kernel ``src/repro/kernels/matmul.py::_matmul_kernel``
(``matmul_kernel_call``).  The kernels are in ``csrc/matmul.cu``; their
plain PyTorch version is :func:`matmul_plain` (``ref.matmul_ref``), which
the CPU path runs and the card is held against, elementwise within the f32
sums' forward error bound k eps |alpha| (|A| @ |B|).

K3 is off the solver path.  The reference's docstring names Q1 Q2^T,
U = Q_p V and the formation of H as its users, but its code computes all
three with ``jnp`` (``core/zolo.py``, ``core/qdwh.py::form_h``,
``solver/planner.py``); only ``repro.kernels.ops.matmul`` reaches the
kernel.  The port keeps the same split: its solver leaves those products
to ``torch.matmul``, and K3 is reached through
:func:`repro_torch.kernels.ops.matmul` alone.

Two routes, chosen by :func:`matmul_route` from the operands' dtypes and
k before the launch (a rule, not a fallback on failure):

* ``"wgmma"`` — bf16 A and bf16 B (k >= 1): TMA + ``wgmma`` on the tensor
  cores, bf16 products summed in f32, 128 x 256 output tiles.  Bound on
  the H100: operations, 2 m n k flops at 989 TFLOP/s (3.5 ms at 11,999^3).
  TMA needs a leading dimension that is a multiple of 8 elements and a
  16-byte aligned base (:func:`tma_layout`); any other operand is staged by
  :func:`stage_bf16` into a buffer whose rows are padded to a multiple of 8
  (a ``copy_``, counted in the call's time: on an H100 80GB HBM3 at 700 W,
  the staged call at 11,999^3 took 6.68 ms against 5.05 ms zero-copy at
  12,000^3, ``chip_smoke.py``).  The tensor map keeps the true extent, so
  the pad is never read.  Row-major operands and transposed views are both taken as they
  lie (K-major or MN-major ``wgmma`` operands).
* ``"simt"`` — every other pair: true f32 FFMA products (no TF32), 128 x
  128 tiles of 128 threads (8 x 16 outputs each) fed by a 2-stage ring of
  32-deep ``cp.async`` copies, any strides.  Bound: 2 m n k flops at 67
  TFLOP/s (51.6 ms at 11,999^3).  A bf16 operand beside an f32 one is
  widened to f32 first (exact); no f32 operand is ever rounded to bf16.

``launches`` counts kernel launches made through
:func:`matmul_kernel_call`, and ``launches_by_route`` splits them by route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import matmul_ref

matmul_plain = matmul_ref  # the plain PyTorch version of this kernel

# accumulation dtype of the kernel's sums, and where the conditioning
# envelope measured at it lives (kernel-accum-envelope lint)
MATMUL_ACCUM_DTYPE = torch.float32
MATMUL_KAPPA_ENVELOPE = "repro_torch.core.svd:CUDA_KAPPA_ENVELOPE"
MATMUL_INPUT_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("simt", "wgmma")
_MAX_DIM = 65_535 * 128  # keeps tile counts and row offsets in int range
TMA_ALIGN_ELEMS = 8      # a TMA stride is a multiple of 16 bytes
TMA_ALIGN_BYTES = 16     # ... and so is its base address

launches = 0
launches_by_route = {r: 0 for r in ROUTES}


def matmul_route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route of ``a @ b``: ``"wgmma"`` for two bf16 operands with
    k >= 1, else ``"simt"``.  Reads dtypes and shapes only."""
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16 and \
            a.shape[1] > 0:
        return "wgmma"
    return "simt"


def tma_layout(t: torch.Tensor) -> Optional[Tuple[str, int]]:
    """How TMA can read the 2-D bf16 operand ``t`` as it lies:
    ``("row", ld)`` (unit stride along columns), ``("col", ld)`` (unit
    stride along rows, a transposed view), or ``None`` when its leading
    dimension is not a multiple of 8 elements or its base is not 16-byte
    aligned (then :func:`stage_bf16` copies it).  Reads strides and the
    data pointer only."""
    if t.data_ptr() % TMA_ALIGN_BYTES:
        return None
    rows, cols = t.shape
    s0, s1 = t.stride()
    if s1 == 1 and s0 % TMA_ALIGN_ELEMS == 0 and s0 >= cols:
        return "row", s0
    if s0 == 1 and s1 % TMA_ALIGN_ELEMS == 0 and s1 >= rows:
        return "col", s1
    return None


def stage_bf16(t: torch.Tensor) -> torch.Tensor:
    """A row-major copy of the 2-D ``t`` whose leading dimension is rounded
    up to a multiple of 8 elements: a (rows, cols) view of a fresh (rows,
    ld) buffer (``stride(0)`` reports ld).  The pad columns are left
    unwritten: the kernel's tensor map never reads them."""
    rows, cols = t.shape
    ld = -(-cols // TMA_ALIGN_ELEMS) * TMA_ALIGN_ELEMS
    buf = torch.empty((rows, ld), dtype=t.dtype, device=t.device)
    view = buf[:, :cols]
    view.copy_(t)
    return view


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
    alpha_ptr = None if alpha_buf is None else alpha_buf.data_ptr()
    c = torch.empty((m, n), dtype=MATMUL_ACCUM_DTYPE, device=a.device)
    lib = _build.library("matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    route = matmul_route(a, b)
    if route == "wgmma":
        la, lb = tma_layout(a), tma_layout(b)
        if la is None:
            a = stage_bf16(a)
            la = ("row", a.stride(0))
        if lb is None:
            b = stage_bf16(b)
            lb = ("row", b.stride(0))
        # A column-major is MN-major (its m axis contiguous); B row-major is
        # MN-major (its n axis contiguous)
        code = lib.zolo_matmul_bf16(
            a.data_ptr(), int(la[0] == "col"), la[1], b.data_ptr(),
            int(lb[0] == "row"), lb[1], c.data_ptr(), m, n, k, alpha_val,
            alpha_ptr, stream)
    else:
        a, b = a.float(), b.float()  # widens a bf16 operand exactly
        code = lib.zolo_matmul_f32(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
            a.stride(1), b.stride(0), b.stride(1), alpha_val, alpha_ptr,
            stream)
    _build.check(code, f"matmul kernel ({route})")
    launches += 1
    launches_by_route[route] += 1
    return c
