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

import math

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


def matmul_ref(a: torch.Tensor, b: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """C = alpha * (A @ B), returned in f32 (the reference's ``matmul_ref``).

    Sub-f32 operands are widened to f32 *before* the product (exact for
    bf16), so this is f32 accumulation of the same products the kernel
    takes; alpha multiplies the finished product.  f64 operands multiply
    in f64 and round to f32 once."""
    acc = accum_dtype(torch.promote_types(a.dtype, b.dtype))
    c = (a.to(acc) @ b.to(acc)).to(torch.float32)
    return torch.as_tensor(alpha, dtype=torch.float32, device=c.device) * c


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale=None,
                        window=None) -> torch.Tensor:
    """Attention over (b, s, h, d) tensors, returned in f32 (the
    reference's ``flash_attention_ref``).

    q is (b, sq, h, d); k and v are (b, skv, h, d).  Query position i sees
    key j iff j <= i + (skv - sq) (when ``causal``) and, with a window w,
    j > i + (skv - sq) - w.  The scale defaults to 1/sqrt(d).  Scores and
    the PV product are f32, with bf16 inputs widened before the products;
    the softmax is computed in f64 and rounded to f32 (see below); a fully
    masked row gives NaN, as the reference's does."""
    f32 = torch.float32
    sq, d = q.shape[1], q.shape[3]
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = logits.masked_fill(~mask, float("-inf"))
    # the softmax is exponentiated and normalized in f64 and rounded to
    # f32 once: torch's vectorized f32 exp on the CPU does not give the
    # same bits in every process, and f64 rounds those differences away
    z = (logits - logits.amax(dim=-1, keepdim=True)).double()
    p = torch.exp(z)
    p = (p / p.sum(dim=-1, keepdim=True)).to(f32)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(f32))


# K5's block: the columns of a diagonal block and the rows of a panel
# (csrc/cholesky.cu: kNB); and its panel workspace's rows, the depth of a
# trailing update (kDepth there, where its timings are)
CHOLESKY_BLOCK = 128
CHOLESKY_DEPTH = 4 * CHOLESKY_BLOCK


def cholesky_ref(z: torch.Tensor, block: int = CHOLESKY_BLOCK,
                 depth: int = CHOLESKY_DEPTH):
    """(L, info) of a stack of symmetric matrices, as
    ``torch.linalg.cholesky_ex`` returns them: L lower (zero above the
    diagonal, batched column-major strides), info int32 of the batch shape,
    0 or the 1-based index of the first pivot that is not positive and
    finite (L is then unspecified for that entry).  Reads Z's lower
    triangle only.

    K5's blocked algorithm step for step (``csrc/cholesky.cu``), on M = Lᵀ
    row-major: for each outer step of ``depth`` columns (a multiple of
    ``block``), for each ``block``-wide diagonal block inside it: the strip
    update from the step's earlier panels, the block's unblocked factor,
    the panel's forward substitution (also written to the workspace W);
    then the trailing update M22 -= WᵀW over the step's panels."""
    n = z.shape[-1]
    batch_shape = z.shape[:-2]
    m = torch.triu(z.reshape(-1, n, n).mT).contiguous()
    b = m.shape[0]
    info = torch.zeros(b, dtype=torch.int32, device=z.device)
    w = torch.empty((b, depth, n), dtype=m.dtype, device=z.device)
    for o in range(0, n, depth):
        e = min(o + depth, n)
        for s in range(o, e, block):
            nb = min(block, n - s)
            if s > o:
                _chol_update_ref(m, w[:, :s - o, s - o:n - o], s, s + nb)
            _chol_diag_ref(m, s, nb, info)
            if s + nb < n:
                x = _chol_panel_ref(m, s, nb)
                m[:, s:s + nb, s + nb:] = x
                w[:, s - o:s - o + nb, s + nb - o:n - o] = x
        if e < n:
            _chol_update_ref(m, w[:, :e - o, e - o:n - o], e, n)
    return m.reshape(batch_shape + (n, n)).mT, info.reshape(batch_shape)


def _chol_update_ref(m, w, g, rows_end):
    """M[g:rows_end, g:] -= the upper part of (WᵀW)[:rows_end - g]."""
    upd = w[:, :, :rows_end - g].mT @ w
    m[:, g:rows_end, g:] -= torch.triu(upd)


def _chol_diag_ref(m, s, nb, info):
    """Unblocked factor of the diagonal block at (s, s), in K5's order:
    pivot j scales row j by 1/sqrt(piv), then S[r][c] -= S[j][r] (S[j][c] /
    piv) for j < r <= c.  Sets info at the first bad pivot."""
    a = m[:, s:s + nb, s:s + nb].clone()
    for j in range(nb):
        piv = a[:, j, j]
        bad = ~(piv > 0) | torch.isinf(piv)
        info.copy_(torch.where(bad & (info == 0), s + j + 1, info))
        d = torch.sqrt(piv)
        rd = 1.0 / d
        sj = a[:, j, j + 1:].clone()
        u = sj * rd[:, None]
        a[:, j, j + 1:] = u
        a[:, j, j] = d
        a[:, j + 1:, j + 1:] -= sj[:, :, None] * (u * rd[:, None])[:, None, :]
    m[:, s:s + nb, s:s + nb] = torch.triu(a)


def _chol_panel_ref(m, s, nb):
    """U11⁻ᵀ M12 by forward substitution, a row of M12 at a time."""
    u = m[:, s:s + nb, s:s + nb]
    x = m[:, s:s + nb, s + nb:].clone()
    for q in range(nb):
        x[:, q] /= u[:, q, q, None]
        x[:, q + 1:] -= u[:, q, q + 1:, None] * x[:, q:q + 1]
    return x
