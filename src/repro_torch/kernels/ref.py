"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each is the same function its kernel computes, written with torch ops:
the CPU path of every wrapper in :mod:`repro_torch.kernels.ops`, and what
the kernels are held against on the card.

Precision contract (``repro/core/zolo.py::_gram``): accumulate in
f32-or-better and return f32-or-better.  A torch bf16 matmul returns
bf16, so sub-f32 inputs are widened *before* the product; products of
bf16 values are exact in f32, so this equals f32 accumulation of bf16
products.
"""

from __future__ import annotations

import torch

# Ridge floor multiplier for a positive Gram shift in sub-f64
# accumulation: c is raised to >= factor * eps(accum) * max diag(G)
# before Z = G + cI is factorized (``repro/core/zolo.py::_clamp_shift``).
# At kappa >~ 1e4 the odd Zolotarev shifts fall below the f32 Gram's
# eps-level negative eigenvalue noise and the Cholesky goes indefinite;
# an eps-of-the-accumulator ridge is below G's own rounding error.
SHIFT_RIDGE_FACTOR = 8.0


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32-or-better: the accumulation (and output) dtype for ``dtype``."""
    return torch.promote_types(dtype, torch.float32)


def clamp_shift(c, g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Ridge positive shifts ``c`` against the *global* max diagonal of
    ``g`` when ``dtype`` is at most 4 bytes wide; f64 passes unchanged.

    ``c`` may be a scalar or a vector of shifts; zero and negative shifts
    are never touched."""
    c = torch.as_tensor(c, dtype=g.dtype, device=g.device)
    if dtype.itemsize > 4:
        return c
    accum = accum_dtype(dtype)
    diag_max = torch.amax(torch.diagonal(g, dim1=-2, dim2=-1))
    floor = (SHIFT_RIDGE_FACTOR * torch.finfo(accum).eps
             * torch.clamp(diag_max, min=0.0)).to(c.dtype)
    return torch.where(c > 0, torch.maximum(c, floor), c)


def gram_ref(a: torch.Tensor, c=0.0) -> torch.Tensor:
    """G = A^T A (+ c I) over the last two axes, f32-or-better.

    A python-scalar ``c == 0`` adds nothing.  Any other ``c`` is clamped
    by :func:`clamp_shift` against the global max diagonal (the engine's
    ``_gram`` semantics; the Pallas kernel clamped per 256-wide tile,
    which agrees only for n <= 256)."""
    acc = accum_dtype(a.dtype)
    a = a.to(acc)
    g = a.mT @ a
    if isinstance(c, (int, float)) and c == 0.0:
        return g
    n = a.shape[-1]
    c_eff = clamp_shift(c, g, g.dtype)
    return g + c_eff * torch.eye(n, dtype=g.dtype, device=g.device)


def grouped_combine_ref(x: torch.Tensor, t: torch.Tensor, a, mhat,
                        xw=1.0) -> torch.Tensor:
    """Y = mhat * (xw * X + sum_j a_j T_j), accumulated in f32-or-better,
    returned in X's dtype.  ``t`` is (r, m, n)."""
    ct = accum_dtype(x.dtype)
    dev = x.device
    acc = (torch.as_tensor(xw, dtype=ct, device=dev) * x.to(ct)
           + torch.einsum("j,jmn->mn",
                          torch.as_tensor(a, dtype=ct, device=dev),
                          t.to(ct)))
    return (torch.as_tensor(mhat, dtype=ct, device=dev) * acc).to(x.dtype)


def polar_update_ref(x: torch.Tensor, t: torch.Tensor, a,
                     mhat) -> torch.Tensor:
    """X2 = mhat * (X + sum_j a_j T_j): :func:`grouped_combine_ref` with
    xw = 1 (the reference's f32-only oracle, widened to f32-or-better)."""
    return grouped_combine_ref(x, t, a, mhat, 1.0)
