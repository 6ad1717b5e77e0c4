"""Public wrappers of the port's kernels.

A tensor on the CPU goes to the plain PyTorch version (``ref``); a CUDA
tensor launches the hand-written kernel, or the launch wrapper raises on
a dtype, shape or layout the kernel does not take.  There is no switch
that silently routes a CUDA tensor to the plain version.  The reference's
TPU lane-alignment padding (``_tile_align``/``_pick_tile``/``_pad_to``)
has no counterpart: the kernels mask their ragged edges.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cholesky import cholesky_kernel_call
from repro_torch.kernels.flash_attention import flash_attention_kernel_call
from repro_torch.kernels.gram import gram_kernel_call
from repro_torch.kernels.grouped_combine import grouped_combine_kernel_call
from repro_torch.kernels.matmul import matmul_kernel_call
from repro_torch.kernels.polar_update import polar_update_kernel_call


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def gram(a: torch.Tensor, c=0.0) -> torch.Tensor:
    """G = A^T A + c I with f32 accumulation (f32-or-better on the CPU),
    a positive c clamped against the global max diagonal."""
    if _on_cpu(a):
        return ref.gram_ref(a, c)
    return gram_kernel_call(a, c)


def matmul(a: torch.Tensor, b: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """C = alpha * A @ B with f32 accumulation, returned in f32."""
    if _on_cpu(a):
        return ref.matmul_ref(a, b, alpha)
    return matmul_kernel_call(a, b, alpha)


def polar_update(x, t, a, mhat):
    """X2 = mhat * (X + sum_j a_j T_j), in X's dtype."""
    if _on_cpu(x):
        return ref.polar_update_ref(x, t, a, mhat)
    return polar_update_kernel_call(x, t, a, mhat)


def grouped_combine(x, t, a, mhat, xw=1.0):
    """Y = mhat * (xw * X + sum_j a_j T_j) — one group's pre-all-reduce
    contribution (``xw`` one-hot over groups), in X's dtype."""
    if _on_cpu(x):
        return ref.grouped_combine_ref(x, t, a, mhat, xw)
    return grouped_combine_kernel_call(x, t, a, mhat, xw)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of (b, s, h, d) q, k, v (GQA expanded), scale
    1/sqrt(d), returned in q's dtype.  Windows and sq != skv are not this
    op's: call ``ref.flash_attention_ref`` for those."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=True).to(q.dtype)
    return flash_attention_kernel_call(q, k, v)


def cholesky(z: torch.Tensor):
    """(L, info) of an f32 stack (..., n, n), as ``torch.linalg.cholesky_ex``
    returns them; K5's blocked algorithm (its plain version on the CPU)."""
    if _on_cpu(z):
        return ref.cholesky_ref(z)
    return cholesky_kernel_call(z)
