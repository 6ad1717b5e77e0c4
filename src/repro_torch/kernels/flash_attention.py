"""K4: causal flash attention — the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``
(``flash_attention_kernel_call``).  The kernels are in
``csrc/flash_attention.cu``; their plain PyTorch version is
:func:`flash_attention_plain` (``ref.flash_attention_ref``).

Like the Pallas kernel, it computes causal self-attention only: q, k and
v are (b, s, h, d) with GQA already expanded, the scale is 1/sqrt(d), the
online-softmax state is f32, masked scores are -1e30 and the output is in
q's dtype.  P is rounded to v's dtype before the PV product and the
denominator is summed from the unrounded P, as the Pallas body does, so a
bf16 kernel rounds where the reference kernel rounds; the plain version
keeps P in f32, so a bf16 kernel is held to it elementwise within
2^-8 (P|V|)_ij for P's rounding plus 2^-8 |o_ij| for the output's (and
an f32 term).  Sliding windows and
sq != skv live only in the plain version.  The tensors are read through
their strides: the reference wrapper's (b h, s, d) transposes are never
made.

What bounds it on the H100: operations.  The causal half needs
2 b h s^2 d flops, 1.37e11 at qwen3-8b's layer (h = 32, d = 128,
s = 4,096): 0.139 ms at 989 TFLOP/s on the bf16 tensor cores, 2.05 ms at
67 TFLOP/s (f32 outside the tensor cores).  Two routes, chosen by
:func:`flash_route` from dtype, d, strides and alignment before the launch
(a rule, not a fallback on failure):

* ``"wgmma"`` — bf16 with d in {64, 128} whose strides over s, h and b are
  multiples of 8 elements and whose bases are 16-byte aligned (what a TMA
  tensor map can describe: contiguous (b, s, h, d) and the transposed
  (b, h, s, d) view both qualify).  128-query blocks of two consumer
  warpgroups; K and V tiles of 128 keys through a 2-stage TMA ring; QK^T
  and PV as ``wgmma`` with f32 accumulators, P rounded to bf16 in the
  registers that feed the PV product.
* ``"simt"`` — every other input (f32, other d, other strides): a SIMT
  FFMA kernel with 128-query blocks (64 at d > 128) that loop over 64-key
  tiles in shared memory, skipping the tiles above the diagonal (all
  masked), with 8 x 4 score and 8 x 8 output register tiles per thread
  (d <= 128), P kept transposed in shared memory, and f32 K and V tiles
  prefetched by ``cp.async`` under the computation.

``launches`` counts kernel launches made through
:func:`flash_attention_kernel_call`, and ``launches_by_route`` splits them
by route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import flash_attention_ref

flash_attention_plain = flash_attention_ref  # the plain PyTorch version

# accumulation dtype of the kernel's sums, and where the conditioning
# envelope measured at it lives (kernel-accum-envelope lint)
FLASH_ACCUM_DTYPE = torch.float32
FLASH_KAPPA_ENVELOPE = "repro_torch.core.svd:CUDA_KAPPA_ENVELOPE"
FLASH_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
ROUTES = ("simt", "wgmma")
WGMMA_HEAD_DIMS = (64, 128)
TMA_ALIGN_ELEMS = 8   # a TMA stride is a multiple of 16 bytes
TMA_ALIGN_BYTES = 16  # ... and so is its base address

launches = 0
launches_by_route = {r: 0 for r in ROUTES}


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route of causal attention over (b, s, h, d) q, k, v:
    ``"wgmma"`` for bf16 with d in {64, 128}, unit stride along d, strides
    over b, s and h that are multiples of 8 elements and 16-byte aligned
    bases; ``"simt"`` for every other input.  Reads dtypes, shapes,
    strides and data pointers only."""
    if q.dtype != torch.bfloat16 or q.shape[3] not in WGMMA_HEAD_DIMS:
        return "simt"
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or t.stride(3) != 1 or \
                t.data_ptr() % TMA_ALIGN_BYTES or \
                any(t.stride(i) % TMA_ALIGN_ELEMS for i in (0, 1, 2)):
            return "simt"
    return "wgmma"


def flash_attention_kernel_call(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """Launch K4: causal attention of CUDA tensors q, k, v, each
    (b, s, h, d) of one dtype (f32 or bf16) with unit stride along d and
    any other strides, 1 <= d <= 256.  Returns a new row-major
    (b, s, h, d) tensor in q's dtype.  Raises on anything the kernel does
    not take."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"flash attention kernel takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in FLASH_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash attention kernel takes q, k, v of one dtype "
                         f"in {FLASH_DTYPES}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention kernel takes causal self-attention "
                         f"over (b, s, h, d) q, k, v of one shape (GQA "
                         f"expanded), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel takes 1 <= d <= "
                         f"{MAX_HEAD_DIM}, got d={d}")
    if any(t.stride(3) != 1 for t in (q, k, v)) and d > 1:
        raise ValueError(f"flash attention kernel needs unit stride along d, "
                         f"got strides {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    if max(b * s * h * d, b * h * -(-s // 64)) >= 2 ** 31:
        raise ValueError(f"flash attention kernel takes fewer than 2^31 "
                         f"elements and blocks, got {tuple(q.shape)}")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in (0, 1, 2)))
    lib = _build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    route = flash_route(q, k, v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if route == "wgmma":
        code = lib.zolo_flash_attention_bf16(
            *ptrs, b, s, h, d, strides, 1.0 / math.sqrt(d), stream)
    else:
        code = lib.zolo_flash_attention(
            int(q.dtype == torch.bfloat16), *ptrs, b, s, h, d, strides,
            1.0 / math.sqrt(d), stream)
    _build.check(code, f"flash attention kernel ({route})")
    launches += 1
    launches_by_route[route] += 1
    return o
