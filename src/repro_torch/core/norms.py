"""Spectral-bound estimators for the polar-decomposition drivers.

Port of the main-path part of ``repro/core/norms.py``:

* ``sigma_max_upper`` — guaranteed upper bound
  min(sqrt(||A||_1 ||A||_inf), ||A||_F).
* ``sigma_max_power`` — power iteration (sharp, lower-biased).

The reference draws the power iteration's start vector from
``jax.random.normal(PRNGKey(0))``, which torch cannot reproduce.  Here
the start vector is explicit (``v0``), or drawn from a ``torch.Generator``
(seed 0 on the input's device unless one is given).  The vector sets the
planner's prescale alpha, so parity tests hand both packages the same one.
"""

from __future__ import annotations

from typing import Optional

import torch


def frobenius(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.abs(a) ** 2))


def frobenius_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(||a||_F, ||b||_F) as one stacked length-2 vector (the
    ``ZoloOps.fnorm_pair`` slot; distributed bundles fuse both sums)."""
    return torch.sqrt(torch.stack([torch.sum(torch.abs(a) ** 2),
                                   torch.sum(torch.abs(b) ** 2)]))


def sigma_max_upper(a: torch.Tensor) -> torch.Tensor:
    """Guaranteed upper bound on sigma_max:
    min(sqrt(||A||_1 ||A||_inf), ||A||_F)."""
    n1 = torch.amax(torch.sum(torch.abs(a), dim=-2))
    ninf = torch.amax(torch.sum(torch.abs(a), dim=-1))
    return torch.minimum(torch.sqrt(n1 * ninf), frobenius(a))


def sigma_max_power(a: torch.Tensor, iters: int = 10, *,
                    v0: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Power iteration on A^T A; sharp estimate of sigma_max (lower-biased,
    so callers wanting a bound multiply by a safety factor).

    ``v0`` is the start vector (shape (..., n)); without it a Gaussian
    one is drawn from ``generator`` — by default a fresh one seeded with 0
    on ``a``'s device, so repeated calls agree."""
    n = a.shape[-1]
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=a.device).manual_seed(0)
        v = torch.randn(a.shape[:-2] + (n,), generator=generator,
                        dtype=a.dtype, device=a.device)
    else:
        v = v0.to(device=a.device, dtype=a.dtype).expand(
            a.shape[:-2] + (n,))
    tiny = torch.finfo(a.dtype).tiny
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        w = torch.einsum("...mn,...n->...m", a, v)
        u = torch.einsum("...mn,...m->...n", a, w)
        v = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1,
                                                     keepdim=True), min=tiny)
    return torch.linalg.vector_norm(torch.einsum("...mn,...n->...m", a, v),
                                    dim=-1)
