"""Symmetric eigensolver for the H-factor stage (paper Alg. 2 step 2).

Port of ``eigh`` from ``repro/core/eig.py``; the block-Jacobi solvers
belong to a later slice.
"""

from __future__ import annotations

import torch


def eigh(h: torch.Tensor):
    """(w ascending, v) with h v = v diag(w), like ``jnp.linalg.eigh``."""
    return torch.linalg.eigh(h)
