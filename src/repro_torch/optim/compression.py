"""Low-rank compression through the partial-spectrum planner.

Port of ``repro/optim/compression.py``: :func:`lowrank_truncate` only.
``compressed_psum`` needs the collectives of the (r, sep) distribution
and the PowerSGD helpers come with ZoloMuon; neither is ported yet.
"""

from __future__ import annotations


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
