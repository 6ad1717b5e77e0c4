"""Structured blocked Householder QR of M = [X; sqrt(c) I]  (paper §3.1).

Port of ``repro/core/structured_qr.py``.  The bottom identity block of
the stacked (m+n) x n matrix is sparse, so the Householder panels need
only m+NB rows: the support of panel p — the still-active X rows
[p*NB, m) plus the identity rows [0, (p+1)*NB) that carry fill-in — is
the contiguous row window [p*NB, p*NB + m + NB) of the stack.  The
algorithm is a sliding (m+NB)-row window:

    panel p:  W = M[p*NB : p*NB+m+NB, :]
              QR of W[:, J_p]  (pivots on the X rows, as PDGEQRF, which
                                keeps row-wise backward stability: the
                                tiny sqrt(c) rows are never pivots)
              block-reflector update of W's trailing columns

and the explicit Q = [Q1; Q2] (the MPDORGQR role) applies the stored
reflectors in reverse to [I_n; 0] through the same window.  The loops
are host loops over panels; every product is a torch op on the window's
view, so on a CUDA tensor they run on the card.

Differences from the reference, each deliberate:

* The panel factorization is LAPACK's: ``torch.geqrf`` (``dgeqrf``, or
  cuSOLVER's on the card) of the (m+NB) x NB panel, whose ``dlarfg``
  reflectors follow the reference's column loop (beta = -sign(alpha)
  ||x||, tau = (beta - alpha) / beta; tau = 0 and the pivot left as
  alpha when the tail is zero).  The reference's 32-step column loop of
  matvecs, carried over as torch ops, would take ~8 launches per column.
* The block-reflector factor T comes from one triangular solve:
  T^{-1} = diag(1/tau) + striu(V^T V), the closed form of LAPACK's
  ``larft`` recurrence (Joffrain et al. 2006), with a tau = 0 reflector
  decoupled to a zero row and column of T, as the recurrence leaves it.
* The trailing update touches only the columns >= start + NB (the
  reference masks the others to an exact zero update), and the Q
  formation only the columns >= start (their window part is still
  exactly zero there, as in LAPACK's ``orgqr``): the arithmetic on the
  columns that change is the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core import linalg as _linalg


def _householder_panel(panel):
    """Householder QR of a (rows x nb) panel (LAPACK geqrf + larft).

    Returns (v, tau, t, r_top): v (rows, nb) the reflector columns (unit
    diagonal), tau (nb,), t (nb, nb) the upper-triangular block-reflector
    factor with H_1...H_nb = I - V T V^T, and r_top (nb, nb) the R
    block."""
    nb = panel.shape[1]
    a, tau = torch.geqrf(panel)
    v = torch.tril(a, -1)
    v.diagonal().fill_(1.0)
    r_top = torch.triu(a[:nb])
    live = tau != 0
    both = live[:, None] & live[None, :]
    s = torch.triu(v.mT @ v, 1) * both
    s = s + torch.diag(torch.where(live, tau, torch.ones_like(tau))
                       .reciprocal())
    eye = torch.eye(nb, dtype=a.dtype, device=a.device)
    t = torch.linalg.solve_triangular(s, eye, upper=True) * live[:, None]
    return v, tau, t, r_top


def structured_qr_factor(x, sqrt_c, block: int = 32):
    """Blocked structured QR of [X; sqrt_c * I] by the sliding-window
    elimination of the module docstring.

    Returns (r, v_all, t_all): r the n x n upper-triangular factor, and
    (v_all, t_all) the per-panel block reflectors (window-local rows) for
    :func:`apply_q_structured`.  Requires n % block == 0 (callers pad)
    and m >= n."""
    m, n = x.shape
    if n % block != 0:
        raise ValueError(f"structured QR needs n padded to a multiple "
                         f"of the panel width: n={n}, block={block}")
    if m < n:
        raise ValueError(f"structured QR expects a tall X; got "
                         f"({m}, {n})")
    nb = block
    npanels = n // nb
    win = m + nb
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    s = torch.cat([x, sqrt_c * eye], dim=0)
    del eye
    v_all = x.new_zeros((npanels, win, nb))
    t_all = x.new_zeros((npanels, nb, nb))
    for p in range(npanels):
        start = p * nb
        w = s[start:start + win]  # view: writes land in s
        v, _, t, r_top = _householder_panel(w[:, start:start + nb])
        trail = w[:, start + nb:]
        if trail.shape[1]:
            # W <- (I - V T^T V^T) W on the trailing columns, in place
            trail.addmm_(v, t.mT @ (v.mT @ trail), alpha=-1.0)
        # the panel's columns exactly: the R block on top, zeros below
        w[:, start:start + nb] = 0.0
        w[:nb, start:start + nb] = r_top
        v_all[p] = v
        t_all[p] = t
    return torch.triu(s[:n]), v_all, t_all


def apply_q_structured(v_all, t_all, m: int, block: int = 32):
    """Explicit thin Q = [Q1; Q2] (the MPDORGQR role): the block
    reflectors applied in reverse to the seed [I_n; 0] through the same
    (m+NB)-row window.  Returns (q1, q2), q1 (m, n), q2 (n, n), with
    [X; sqrt_c I] = [q1; q2] R."""
    npanels, win, nb = v_all.shape
    n = npanels * nb
    seed = torch.cat([torch.eye(n, dtype=v_all.dtype, device=v_all.device),
                      v_all.new_zeros((m, n))], dim=0)
    for p in reversed(range(npanels)):
        start = p * nb
        v = v_all[p]
        # columns < start are still e_j, zero inside the window
        sw = seed[start:start + win, start:]
        sw.addmm_(v, t_all[p] @ (v.mT @ sw), alpha=-1.0)
    return seed[:m], seed[m:]


def structured_qr_q1q2(x, sqrt_c, block: int = 32):
    """Q1, Q2 of the structured factorization [X; sqrt_c I] = [Q1; Q2] R,
    padding n to a multiple of ``block`` (and m up to n if column padding
    makes the X block wide) as needed."""
    m, n = x.shape
    pad = (-n) % block
    rpad = max(0, (n + pad) - m)  # keep the padded X tall
    if pad or rpad:
        x = torch.nn.functional.pad(x, (0, pad, 0, rpad))
    _, v_all, t_all = structured_qr_factor(x, sqrt_c, block=block)
    q1, q2 = apply_q_structured(v_all, t_all, m + rpad, block=block)
    return q1[:m, :n], q2[:n, :n]


def cholesky_qr2(x, shift_scale: float = 1.0):
    """Orthonormalize the columns of a tall ``x`` (..., m, k) by shifted
    CholeskyQR2: a Gram + Cholesky + triangular solve pass run twice.

    The eps-scaled trace shift keeps the Cholesky well-posed when ``x``
    is numerically rank-deficient (the basis then spans range(x) plus
    arbitrary orthonormal fill); ``shift_scale`` scales that ridge.  The
    Gram accumulates in f32-or-better and is cast back to ``x``'s
    dtype."""
    k = x.shape[-1]
    eps = torch.finfo(x.dtype).eps
    acc = torch.promote_types(x.dtype, torch.float32)
    eye = torch.eye(k, dtype=x.dtype, device=x.device)

    def pass_(p):
        pa = p.to(acc)
        g = (pa.mT @ pa).to(p.dtype)
        shift = shift_scale * eps * torch.diagonal(
            g, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        l = _linalg.cholesky(g + shift * eye)
        # P L^{-T}, as the transposed left solve L^{-1} P^T
        return _linalg.solve_triangular(l, p.mT, upper=False).mT

    return pass_(pass_(x))


def dense_stacked_qr_q1q2(x, sqrt_c):
    """Oracle: thin QR of the dense (m+n) x n stack by torch.linalg.qr."""
    m, n = x.shape
    stacked = torch.cat([x, sqrt_c * torch.eye(n, dtype=x.dtype,
                                                device=x.device)], dim=0)
    q, _ = torch.linalg.qr(stacked)
    return q[:m], q[m:]


def structured_qr_flops(m: int, n: int, block: int) -> dict:
    """Analytic flop model: structured vs dense stacked QR (+ Q formation).

    dense geqrf of (M x n), M = m+n:  2 n^2 (M - n/3)
    dense orgqr thin:                 2 n^2 (M - n/3)  (same order)
    structured: every panel works on (m+NB) rows ->
                geqrf ~ 2 n^2 (m + NB)
    """
    mm = m + n
    dense_geqrf = 2.0 * n * n * (mm - n / 3.0)
    dense_orgqr = 2.0 * n * n * (mm - n / 3.0)
    struct_geqrf = 2.0 * n * n * (m + block)
    struct_orgqr = 2.0 * n * n * (m + block)
    return {
        "dense_geqrf": dense_geqrf,
        "dense_orgqr": dense_orgqr,
        "struct_geqrf": struct_geqrf,
        "struct_orgqr": struct_orgqr,
        "speedup_geqrf": dense_geqrf / struct_geqrf,
        "speedup_orgqr": dense_orgqr / struct_orgqr,
    }
