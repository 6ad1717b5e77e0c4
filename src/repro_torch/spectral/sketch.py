"""Randomized sketch frontend for top-k SVD (the PyParSVD direction).

Port of ``repro/spectral/sketch.py``.  When only k singular triplets are
wanted, the O(m n min(m,n)) full factorization is waste — sketch A down
to an O(k)-wide panel, run the *existing* solver on the panel, and lift
the left factor back.  Concretely (canonical tall A, m >= n):

    1.  range finder:  Y = (A A^T)^q A Omega with Omega an n x l test
        matrix (l = k + oversample), orthonormalized between every
        product by shifted CholeskyQR2
        (:func:`repro_torch.core.structured_qr.cholesky_qr2`) so the
        power iterations never lose the small directions to roundoff;
    2.  project:       B = Q^T A   (l x n — an O(k)-width problem);
    3.  solve:         B = U_B diag(s) V^H through a cached
        :class:`repro_torch.solver.SvdPlan` (its backends, the Hopper
        kernels included);
    4.  lift:          U = Q U_B, keep the leading k triplets.

Test matrices: ``kind="gauss"`` (dense Gaussian, 2 m n l flops per
pass) or ``kind="srht"`` (random column signs, fast Walsh-Hadamard over
the column axis, subsample).  The products are plain torch products, as
they are plain ``einsum`` in the reference.

The random draw is kept apart from its use: :func:`sketch_draw` draws
the test matrix (or the SRHT's signs and columns) from a
``torch.Generator``, and every function that uses it takes the drawn
tensors, so a test can hand in the reference's own draw
(:func:`repro_torch.interop.with_draws`).

Accuracy is governed by the decay between sigma_k and sigma_{l+1}:
relative value error ~ (sigma_{l+1}/sigma_k)^(4q+2) after q power
iterations.  :func:`needed_power_iters` inverts that model under the
geometric spectrum sigma_i = kappa^(-(i-1)/(n-1)); ``strategy="auto"`` in
:mod:`repro_torch.spectral.topk` uses it to decide whether the sketch
can reach the configured tolerance at all.  The a posteriori check is
:func:`topk_residual`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch.core import norms as _norms
from repro_torch.core.structured_qr import cholesky_qr2

SKETCH_KINDS = ("gauss", "srht")


def srht_width(n: int) -> int:
    """The SRHT's zero-padded column count: the next power of 2 >= n
    (at least 2)."""
    return 1 << max(1, (n - 1).bit_length())


def sketch_draw(kind: str, n: int, l: int, *, generator: torch.Generator,
                dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The sketch's random draw for an (m, n) input and width l.

    ``kind="gauss"``: ``{"omega": (n, l) standard normal}``;
    ``kind="srht"``: ``{"signs": (n,) of +-1, "cols": (l,) distinct
    column indices below srht_width(n)}``."""
    if kind not in SKETCH_KINDS:
        raise ValueError(f"sketch kind {kind!r} not in {SKETCH_KINDS}")
    if kind == "gauss":
        return {"omega": torch.randn((n, l), generator=generator,
                                     dtype=dtype, device=device)}
    signs = torch.randint(0, 2, (n,), generator=generator, device=device)
    cols = torch.randperm(srht_width(n), generator=generator,
                          device=device)[:l]
    return {"signs": (2 * signs - 1).to(dtype), "cols": cols}


def gaussian_sketch(a, omega):
    """Y = A Omega with Omega an n x l Gaussian test matrix."""
    return a @ omega


def _fwht(x):
    """Fast Walsh-Hadamard transform along the last axis (power-of-2
    length), normalized by 1/sqrt(len): log2(n) reshape-butterfly
    passes, each O(size)."""
    n = x.shape[-1]
    h = 1
    while h < n:
        x = x.reshape(x.shape[:-1] + (n // (2 * h), 2, h))
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(
            x.shape[:-3] + (n,))
        h *= 2
    return x / math.sqrt(n)


def srht_sketch(a, signs, cols):
    """Y = A D H S: random column signs, Walsh-Hadamard mix over the
    column axis (zero-padded to a power of 2), subsample the l columns
    ``cols``.

    The Hadamard mix spreads every right singular direction across all
    columns, so the uniform subsample is a with-high-probability range
    sketch like the Gaussian one at O(m n log n) cost."""
    n = a.shape[-1]
    n_pad = srht_width(n)
    l = cols.shape[-1]
    x = a * signs
    if n_pad != n:
        x = torch.nn.functional.pad(x, (0, n_pad - n))
    x = _fwht(x) * math.sqrt(n_pad / l)
    return torch.index_select(x, -1, cols)


def randomized_range(a, q_iters: int, draw: Dict[str, torch.Tensor],
                     kind: str = "gauss"):
    """Orthonormal Q (m x l) approximately spanning the leading left
    singular subspace of ``a`` after ``q_iters`` power iterations, from
    the drawn test matrix ``draw`` (:func:`sketch_draw`).

    Every half-pass re-orthonormalizes through shifted CholeskyQR2, so
    ill-conditioned spectra (kappa ~ 1e10) neither underflow the small
    directions nor break the Cholesky (the ridge keeps rank-deficient
    iterates factorizable — the k >= rank case)."""
    if kind not in SKETCH_KINDS:
        raise ValueError(f"sketch kind {kind!r} not in {SKETCH_KINDS}")
    y = srht_sketch(a, **draw) if kind == "srht" else \
        gaussian_sketch(a, **draw)
    q = cholesky_qr2(y)
    acc = torch.promote_types(a.dtype, torch.float32)
    aa = a.to(acc)
    for _ in range(int(q_iters)):
        z = cholesky_qr2((aa.mT @ q.to(acc)).to(a.dtype))
        q = cholesky_qr2((aa @ z.to(acc)).to(a.dtype))
    return q


def sketch_topk(a, *, k: int, q_iters: int, draw: Dict[str, torch.Tensor],
                small_svd, kind: str = "gauss"):
    """Leading-k SVD of canonical-tall ``a`` through the sketch.

    ``small_svd`` solves the (l, n) projected panel (a cached
    :class:`repro_torch.solver.SvdPlan`'s solve).  Returns
    (u (m, k), s (k,), vh (k, n)).

    Opens the spans ``topk.sketch`` (the range finder and B = QᵀA, with
    its ``products``: the (m, n, l) products, 2 a power iteration, one
    for the Gaussian first pass and one for B) and ``topk.panel`` (the
    panel's solve and the lift)."""
    m, n = a.shape[-2:]
    l = draw["omega" if kind == "gauss" else "cols"].shape[-1]
    products = 2 * int(q_iters) + (2 if kind == "gauss" else 1)
    with obs.span("topk.sketch", m=m, n=n, l=l, products=products):
        q = randomized_range(a, q_iters, draw, kind=kind)
        b = q.mT @ a
    with obs.span("topk.panel"):
        u_b, s, vh = small_svd(b)
        u = q @ u_b
    return u[..., :, :k], s[..., :k], vh[..., :k, :]


def needed_power_iters(nmin: int, k: int, l: int,
                       kappa: float, tol: float,
                       margin: float = 1e-2) -> Optional[int]:
    """Power iterations needed for relative value error ``tol`` under
    the geometric-spectrum model, or None when no finite count works.

    Model: sigma_i = kappa^(-(i-1)/(nmin-1)), value error after q
    iterations ~ (sigma_{l+1}/sigma_k)^(4q+2); ``margin`` is the safety
    factor absorbing the model's constants.  l >= nmin is the
    exhaustive sketch (exact, 0 iterations); kappa <= 1 (no decay) can
    never converge by decay alone.
    """
    if l >= nmin:
        return 0
    kappa = float(kappa)
    if kappa <= 1.0:
        return None
    # log10 of the per-index decay ratio sigma_{l+1} / sigma_k < 1
    log_rho = -(l + 1 - k) * math.log10(kappa) / max(nmin - 1, 1)
    need = math.log10(float(tol) * margin) / log_rho  # 4q + 2 >= need
    return max(0, math.ceil((need - 2.0) / 4.0))


def sketch_flops(m: int, n: int, k: int, l: int, q_iters: int,
                 small_flops: float = 0.0) -> float:
    """Flop model for one sketch solve of a canonical (m, n) problem:
    first pass + 2 matmuls per power iteration + the CholeskyQR2
    orthonormalizations + projection + lift, plus the caller-supplied
    price of the (l, n) panel solve (from the solver's own cost model —
    see :func:`repro_torch.solver.flops_estimate`)."""
    pass_ = 2.0 * m * n * l
    orth = 2.0 * (2.0 * m * l * l + l ** 3 / 3.0)
    per_iter = 2.0 * pass_ + 2.0 * orth
    return (pass_ + orth + q_iters * per_iter        # range finder
            + pass_                                  # B = Q^T A
            + float(small_flops)                     # SVD of B
            + 2.0 * m * l * k)                       # lift U = Q U_B


def topk_residual(a, u, s, vh):
    """A posteriori residual: max_i ||A v_i - s_i u_i||_2 / sigma_max.

    For an exact leading-k triplet set this is ~eps; a sketch that
    missed part of the leading subspace shows up here at the size of
    what it missed.  One O(m n k) pass.  sigma_max is estimated as
    max(s_1, a power-iteration estimate) so the scale is honest even if
    s itself is off."""
    av = a @ vh.mT
    res = torch.linalg.vector_norm(av - u * s[..., None, :], dim=-2)
    smax = torch.maximum(s[..., 0],
                         _norms.sigma_max_power(a, iters=4).to(s.dtype))
    return torch.amax(res, dim=-1) / torch.clamp(
        smax, min=torch.finfo(s.dtype).tiny)
