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

The Cholesky factorization takes one of two routes, by the input's shape
(:func:`repro_torch.kernels.cholesky.cholesky_route`, named in the span's
``route``): ``"k5"``, a CUDA f32 stack of two or more matrices with n >=
``CHOLESKY_MIN_N``, goes to the hand-written blocked kernel K5;
``"cusolver"``, every other input (every CPU tensor among them), to
``torch.linalg.cholesky_ex``.  Both return the same (L, info), with the
same strides.
"""

from __future__ import annotations

import itertools
import math

import torch

from repro_torch import obs
from repro_torch.kernels import cholesky as _kchol
from repro_torch.kernels import ops as _kops


def cholesky(z: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a batch entry that is not positive definite
    comes out all-NaN instead of raising."""
    route = _kchol.cholesky_route(z)
    with obs.span("linalg.cholesky", batch=math.prod(z.shape[:-2]),
                  n=z.shape[-1], route=route):
        if route == "k5":
            l, info = _kops.cholesky(z)
        else:
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
