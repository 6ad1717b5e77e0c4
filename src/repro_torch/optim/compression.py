"""Low-rank gradient compression.

Port of ``repro/optim/compression.py``: :func:`lowrank_truncate` (the
one-shot truncation through the partial-spectrum planner), the PowerSGD
helpers (:func:`lowrank_factor`, :func:`compress_decompress`,
:func:`init_compression_state`, its random ``q`` drawn from a
``torch.Generator``) and :func:`compressed_psum` (the PowerSGD-style
all-reduce of the rank-k factors instead of the gradient).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.structured_qr import cholesky_qr2 as _cholqr2


def lowrank_truncate(g, rank: int, *, strategy: str = "auto",
                     kappa=None, tol: float = 1e-6):
    """Best-rank-``rank`` factors (p, q) with G ~= P Q^T, through the
    partial-spectrum planner.

    The *one-shot* truncation (checkpoint compression, compression-state
    initialization, accuracy flooring): it plans a
    :class:`repro_torch.spectral.TopKConfig` at G's shape, dtype and
    device and takes the leading-``rank`` triplets, so the result is the
    Eckart-Young optimum to the configured ``tol``.  ``strategy``/``kappa``
    pass through to :func:`repro_torch.spectral.plan_topk` (auto: the
    cost model picks sketch vs dense).  Plans are cached per (shape,
    dtype, device, rank).  A (..., m, n) stack is truncated entry by
    entry.
    """
    from repro_torch.spectral import TopKConfig, plan_topk

    plan = plan_topk(
        TopKConfig(k=int(rank), strategy=strategy, tol=tol,
                   kappa=None if kappa is None else float(kappa)),
        g.shape[-2:], g.dtype, device=g.device)
    u, s, vh = plan.topk(g) if g.ndim == 2 else plan.topk_batched(g)
    return u * s[..., None, :], vh.mT


def lowrank_factor(g, q_prev, rank: int):
    """One subspace-iteration step: G ~= P Q^T, P orthonormal (m, k)."""
    p = g @ q_prev
    p = _cholqr2(p)
    q = g.mT @ p
    return p, q


def compress_decompress(g, err, q_prev, rank: int):
    """Error-feedback low-rank pass.  Returns (g_hat, new_err, q_new)."""
    g_fb = g + err
    p, q = lowrank_factor(g_fb, q_prev, rank)
    g_hat = p @ q.mT
    return g_hat, g_fb - g_hat, q


def init_compression_state(param, rank: int,
                           generator: Optional[torch.Generator] = None):
    """{"err": zeros like ``param`` (f32), "q": (..., n, rank) f32
    Gaussian} on ``param``'s device; ``q`` is drawn from ``generator``
    (a fresh one seeded with 0 on that device when None)."""
    n = param.shape[-1]
    if generator is None:
        generator = torch.Generator(device=param.device).manual_seed(0)
    q = torch.randn(tuple(param.shape[:-2]) + (n, rank), generator=generator,
                    dtype=torch.float32, device=param.device)
    return {"err": torch.zeros(param.shape, dtype=torch.float32,
                               device=param.device), "q": q}


def compressed_psum(g, err, q_prev, rank: int, group):
    """All-reduce the rank-``rank`` factors (P, Q) over the process
    ``group`` rather than G.  Returns (g_hat, new_err, q_new).

    Every rank of ``group`` calls it with its *local* gradient ``g``
    (the same shape on each), its error-feedback buffer ``err`` and the
    shared ``q_prev`` (n, rank).  P = (G + err) Q_prev is summed over the
    group and orthonormalized by shifted CholeskyQR2, Q = (G + err)^T P is
    summed, and ``g_hat = P Q^T / size`` is the group's mean gradient
    through rank-``rank`` factors: the traffic per matrix drops from
    m n to rank (m + n) words."""
    g_fb = g + err
    p = g_fb @ q_prev
    dist.all_reduce(p, group=group)
    p = _cholqr2(p)
    q = g_fb.mT @ p
    dist.all_reduce(q, group=group)
    g_hat = p @ q.mT / dist.get_world_size(group)
    return g_hat, g_fb - g_hat, q
