"""Plain reference of the ``linverse-f32`` configuration: the paper's
linverse matrix (Table 3) matched by a dense synthetic one, and the
numbers that judge an SVD or a top-k answer of it.

The matrix is made here from the seed, the same way the repository's
synthesizer makes the paper's matrices: a geometric spectrum from 1 down
to 1/kappa (times the request's scale) and Haar singular vectors (QR of
Gaussian matrices), formed in float64 and cast to float32.  Its exact
SVD is therefore known: the reference's answer is its own construction,
and nothing the program computed enters it.  Every number is worked out
in float64.

The control (``control_answer``) is that exact answer rounded to TF32
(10 mantissa bits), the precision just below the configuration's
float32 with TF32 off: the best answer any TF32 computation could give.

Plain PyTorch only; imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def spectrum(n: int, kappa: float, scale: float = 1.0, device=None):
    """The exact singular values, descending, in float64."""
    return scale * torch.logspace(0.0, -math.log10(kappa), n, dtype=F64,
                                  device=device)


def factors(n: int, kappa: float, seed: int, scale: float = 1.0,
            device=None):
    """(U, s, V) in float64: Haar U and V, geometric s."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = spectrum(n, kappa, scale, device)
    u, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=F64,
                                       device=device))
    v, _ = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=F64,
                                       device=device))
    return u, s, v


def synthesize(n: int, kappa: float, seed: int, scale: float = 1.0,
               device=None, dtype=torch.float32, k: int = 0):
    """(A, s, U_k, V_k): A = U diag(s) Vᵀ formed in float64 and cast to
    ``dtype``, its exact singular values s and its exact leading ``k``
    singular vectors (float64)."""
    u, s, v = factors(n, kappa, seed, scale, device)
    a = (u * s) @ v.mT
    lead = u[:, :k].clone(), v[:, :k].clone()
    del u, v
    return a.to(dtype), s, *lead


def _orth(q) -> float:
    """‖QᵀQ − I‖_F / k of an (m, k) Q, in float64."""
    k = q.shape[-1]
    g = q.mT @ q
    g.diagonal().sub_(1.0)
    return float(torch.linalg.matrix_norm(g)) / k


def _finite(*ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def dense_numbers(a, s_true, u, s, vh) -> dict:
    """The numbers of a full SVD (U, s, Vh) of ``a``: max|s − s_true| /
    s_max, ‖A − U diag(s) Vh‖_F / ‖A‖_F and the orthogonality of U and
    of Vhᵀ (inf where the answer has the wrong shape, order or a
    non-finite entry)."""
    n = a.shape[-1]
    bad = dict.fromkeys(("s_err", "residual", "orth_u", "orth_v"),
                        math.inf)
    if (tuple(u.shape) != (n, n) or tuple(s.shape) != (n,)
            or tuple(vh.shape) != (n, n) or not _finite(u, s, vh)
            or not bool((s[:-1] >= s[1:]).all())):
        return bad
    s64 = s.to(F64)
    out = {"s_err": float((s64 - s_true).abs().amax() / s_true[0])}
    u64, vh64 = u.to(F64), vh.to(F64)
    a64 = a.to(F64)
    r = a64 - (u64 * s64) @ vh64
    out["residual"] = float(torch.linalg.matrix_norm(r)
                            / torch.linalg.matrix_norm(a64))
    del r, a64
    out["orth_u"] = _orth(u64)
    out["orth_v"] = _orth(vh64.mT)
    return out


def _sin(x, x_true) -> float:
    """The sine of the largest principal angle between the span of the
    (near-orthonormal) columns of ``x`` and that of the orthonormal
    ``x_true``: ‖X − X*(X*ᵀX)‖_2, in float64."""
    return float(torch.linalg.matrix_norm(x - x_true @ (x_true.mT @ x),
                                          ord=2))


def topk_numbers(a, s_true, u_true, v_true, u, s, vh) -> dict:
    """The numbers of a top-k answer (U_k, s_k, Vh_k) of ``a``, whose
    exact singular values are ``s_true`` and exact leading singular
    vectors ``u_true``, ``v_true``: max|s − s_true[:k]| / s_max; the
    residual, max over the triplets of max(‖A v_i − s_i u_i‖, ‖Aᵀ u_i −
    s_i v_i‖) / s_max; the orthogonality of U_k and V_k; and the sines
    ``sin_u``, ``sin_v`` of the largest angle between the answer's
    subspaces and the exact ones (inf where the answer is malformed)."""
    n = a.shape[-1]
    k = s.shape[-1]
    bad = dict.fromkeys(("s_err", "residual", "orth", "sin_u", "sin_v"),
                        math.inf)
    if (tuple(u.shape) != (n, k) or tuple(vh.shape) != (k, n)
            or not _finite(u, s, vh) or not bool((s[:-1] >= s[1:]).all())):
        return bad
    s64 = s.to(F64)
    u64, v64 = u.to(F64), vh.to(F64).mT
    smax = float(s_true[0])
    out = {"s_err": float((s64 - s_true[:k]).abs().amax()) / smax}
    a64 = a.to(F64)
    right = torch.linalg.vector_norm(a64 @ v64 - u64 * s64, dim=0)
    left = torch.linalg.vector_norm(a64.mT @ u64 - v64 * s64, dim=0)
    del a64
    out["residual"] = float(torch.maximum(right, left).amax()) / smax
    out["orth"] = max(_orth(u64), _orth(v64))
    out["sin_u"] = _sin(u64, u_true[:, :k])
    out["sin_v"] = _sin(v64, v_true[:, :k])
    return out


def round_tf32(x):
    """``x`` (float32) rounded to nearest (ties to even) at TF32's 10
    mantissa bits, returned as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def control_answer(n: int, kappa: float, seed: int, scale: float = 1.0,
                   k=None, device=None):
    """The control: the exact answer (U, s, Vh), or its leading ``k``
    triplets, rounded to TF32."""
    u, s, v = factors(n, kappa, seed, scale, device)
    if k is not None:
        u, s, v = u[:, :k], s[:k], v[:, :k]
    return tuple(round_tf32(t.to(torch.float32)) for t in (u, s, v.mT))
