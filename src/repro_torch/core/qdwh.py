"""Polar-decomposition record and the Hermitian factor.

Port of ``PolarInfo`` and ``form_h`` from ``repro/core/qdwh.py``; the
QDWH drivers themselves belong to a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PolarInfo(NamedTuple):
    """Convergence record of one polar solve (fields are tensors on the
    solve's device).

    ``converged`` is the runtime verdict a resilience layer keys on;
    static schedules are converged by construction.  ``l_init`` is the
    sigma_min lower bound the solve ran under (NaN when unknown).
    """

    iterations: torch.Tensor  # scalar int32
    residual: torch.Tensor    # final ||X2 - X1||_F / ||X2||_F
    l_final: torch.Tensor
    converged: torch.Tensor = True
    l_init: torch.Tensor = float("nan")


def form_h(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """H = (Q^T A + (Q^T A)^T) / 2 — the Hermitian polar factor."""
    qa = q.mT @ a
    return 0.5 * (qa + qa.mT)
