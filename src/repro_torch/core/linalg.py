"""Factorizations with ``jnp.linalg``'s failure mode.

``torch.linalg.cholesky`` and ``torch.linalg.inv`` raise on a matrix they
cannot factor, where ``jnp.linalg.cholesky`` and ``jnp.linalg.inv``
return NaN (or inf) and let the solve carry on.  The port's engines keep
the reference's behaviour: the ``_ex`` variants run without a check, and
a failed batch entry is filled with NaN.  No host sync: the fill is a
masked device op.

The Cholesky factorization and the triangular solve open the spans
``linalg.cholesky`` and ``linalg.trsm`` (:mod:`repro_torch.obs`) with
their shapes, from which a reader counts their operations.
"""

from __future__ import annotations

import itertools
import math

import torch

from repro_torch import obs


def cholesky(z: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a batch entry that is not positive definite
    comes out all-NaN instead of raising."""
    with obs.span("linalg.cholesky", batch=math.prod(z.shape[:-2]),
                  n=z.shape[-1]):
        l, info = torch.linalg.cholesky_ex(z)
        return l.masked_fill_((info != 0)[..., None, None], float("nan"))


def solve_triangular(t: torch.Tensor, b: torch.Tensor, *,
                     upper: bool) -> torch.Tensor:
    """T⁻¹B for a triangular T (``torch.linalg.solve_triangular``, a left
    solve), over broadcast batch axes."""
    # the broadcast batch, in plain Python (torch.broadcast_shapes costs
    # tens of microseconds a call)
    batch = math.prod(max(x, y) for x, y in itertools.zip_longest(
        t.shape[-3::-1], b.shape[-3::-1], fillvalue=1))
    with obs.span("linalg.trsm", batch=batch, n=t.shape[-1], k=b.shape[-1]):
        return torch.linalg.solve_triangular(t, b, upper=upper)


def inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse; a batch entry that is exactly singular comes out all-NaN
    instead of raising."""
    xi, info = torch.linalg.inv_ex(x)
    return xi.masked_fill_((info != 0)[..., None, None], float("nan"))
