"""The fused r-term polar update ``X2 = mhat (X + sum_j a_j T_j)``.

Port of ``src/repro/kernels/polar_update.py``: the grouped combine K2
with xw = 1, so there is one kernel body (``csrc/grouped_combine.cu``)
and one launch counter (:data:`repro_torch.kernels.grouped_combine.launches`).
"""

from __future__ import annotations

from repro_torch.kernels.grouped_combine import grouped_combine_kernel_call
from repro_torch.kernels.ref import polar_update_ref

polar_update_plain = polar_update_ref  # the plain PyTorch version


def polar_update_kernel_call(x, t, a, mhat):
    """X2 = mhat * (X + sum_j a[j] T[j]) on K2 (xw = 1.0 is exact in f32,
    so the shared kernel's extra multiply does not perturb the result)."""
    return grouped_combine_kernel_call(x, t, a, mhat, 1.0)
