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
from repro_torch.kernels.gram import gram_kernel_call
from repro_torch.kernels.grouped_combine import grouped_combine_kernel_call
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
