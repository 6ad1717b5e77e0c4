"""K5: batched blocked Cholesky of f32 stacks — the CUDA kernel's wrapper.

Replaces no Pallas kernel (the reference leaves Cholesky to XLA); it takes
the place of ``torch.linalg.cholesky_ex``, cuSOLVER's batched ``potrf``,
where :func:`cholesky_route` says so: a CUDA f32 stack of two or more
matrices with n >= :data:`CHOLESKY_MIN_N`
(:func:`repro_torch.core.linalg.cholesky` opens its span with the route).
The kernels are in ``csrc/cholesky.cu``; their plain PyTorch version is
:func:`cholesky_plain` (``ref.cholesky_ref``), the same blocked algorithm
step for step, which the card is held against (``ops.cholesky`` runs it on
a CPU tensor; the CPU's route stays ``cholesky_ex``).

What bounds it on the H100: operations, b n³/3 flops at 67 TFLOP/s (34 ms
for the dense solve's (4, 11,999, 11,999) stacks), nearly all in the
trailing updates.  What the design does about it: the updates run on K1's
f32 SIMT tiles (upper triangle only) over a panel workspace
``CHOLESKY_DEPTH`` rows deep; the diagonal blocks and panels run for the
whole stack at once (the batch on the grid's z axis); one C call issues
every launch of a factorization, so no Python loop leaves the card idle
between steps.

``launches`` counts factorizations launched through
:func:`cholesky_kernel_call` (one C call each, some hundreds of device
launches at n = 11,999).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import CHOLESKY_DEPTH, cholesky_ref

cholesky_plain = cholesky_ref  # the plain PyTorch version of this kernel

# accumulation dtype of the kernel's sums, and where the conditioning
# envelope measured at it lives (kernel-accum-envelope lint)
CHOLESKY_ACCUM_DTYPE = torch.float32
CHOLESKY_KAPPA_ENVELOPE = "repro_torch.core.svd:CUDA_KAPPA_ENVELOPE"
# CHOLESKY_DEPTH, the rows of the panel workspace a trailing update sums
# over, is four blocks (csrc/cholesky.cu: kDepth, where its timings are).
# The smallest stack and the smallest n that take K5.  On an H100
# (chip_smoke.py phase 4c's sweep, ms, K5 against cholesky_ex): at batch 4
# K5 is faster at every n swept, 0.78 / 1.26 at 877, 0.91 / 1.56 at 1,024,
# 1.30 / 2.54 at 1,408, 2.14 / 4.78 at 2,048, 5.97 / 18.4 at 4,096, 68.7 /
# 260 at 11,999 (cholesky_ex runs cuSOLVER's batched potrf), and at batch 2
# from 0.77 / 1.17 at 877 to 39.1 / 170 at 11,999; at batch 1 it is slower
# at every n, 0.77 / 0.31 at 877 up to 24.7 / 20.7 at 11,999 (cuSOLVER's
# single-matrix potrf runs its updates on cuBLAS's SGEMM and SYRK).  So a
# single matrix keeps cholesky_ex: CHOLESKY_MIN_BATCH is measured.
# CHOLESKY_MIN_N is not a crossover (the sweep found none down to 877): it
# is a limit of scope that keeps the top-k cell's 877-wide factorizations
# on cholesky_ex as they were; where K5 should start below it is not yet
# measured.
CHOLESKY_MIN_N = 1024
CHOLESKY_MIN_BATCH = 2
# the devices whose tensors take K5: the card's only (the CPU's plain
# version would be a Python loop in place of LAPACK)
K5_DEVICES = ("cuda",)
MAX_BATCH = 65535  # the grid's z axis

launches = 0


def cholesky_route(z: torch.Tensor) -> str:
    """``"k5"`` for an f32 (..., n, n) stack of at least
    ``CHOLESKY_MIN_BATCH`` matrices with n >= ``CHOLESKY_MIN_N`` on the
    card; else ``"cusolver"`` (``cholesky_ex`` as it is).  Reads the
    dtype, shape and device type only."""
    if (z.dtype == torch.float32 and z.ndim >= 3
            and z.shape[-1] >= CHOLESKY_MIN_N
            and math.prod(z.shape[:-2]) >= CHOLESKY_MIN_BATCH
            and z.device.type in K5_DEVICES):
        return "k5"
    return "cusolver"


def cholesky_kernel_call(z: torch.Tensor):
    """Launch K5 on a CUDA f32 stack ``z`` (..., n, n), any strides (only
    its lower triangle is read).  Returns (L, info) as
    ``torch.linalg.cholesky_ex`` does: L new, lower, with batched
    column-major strides; info int32 of the batch shape.  Raises on any
    dtype, shape or device the kernel does not take."""
    global launches
    if z.device.type != "cuda":
        raise ValueError(f"cholesky kernel takes a CUDA tensor, got "
                         f"{z.device}")
    if z.dtype != torch.float32:
        raise ValueError(f"cholesky kernel takes float32, got {z.dtype}")
    if z.ndim < 2 or z.shape[-1] != z.shape[-2] or z.shape[-1] < 1:
        raise ValueError(f"cholesky kernel takes a stack of square "
                         f"matrices, got shape {tuple(z.shape)}")
    n = z.shape[-1]
    batch_shape = z.shape[:-2]
    b = math.prod(batch_shape)
    if b > MAX_BATCH or n >= 2 ** 31 // 4:
        raise ValueError(f"cholesky kernel takes a batch <= {MAX_BATCH} "
                         f"and n < 2^29, got {b} x {n}")
    zb = z.reshape(b, n, n)
    m = z.new_empty((b, n, n), dtype=CHOLESKY_ACCUM_DTYPE)
    info = z.new_empty((b,), dtype=torch.int32)
    if b > 0:
        ldw = -(-n // 4) * 4  # float4 rows for the trailing update
        w = z.new_empty((b, CHOLESKY_DEPTH, ldw),
                        dtype=CHOLESKY_ACCUM_DTYPE)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = _build.library("cholesky").zolo_cholesky_f32(
            zb.data_ptr(), *zb.stride(), m.data_ptr(), n, b, w.data_ptr(),
            ldw, info.data_ptr(), stream)
        _build.check(code, "cholesky kernel")
        launches += 1
    return m.reshape(batch_shape + (n, n)).mT, info.reshape(batch_shape)
