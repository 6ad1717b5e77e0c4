"""Factorizations with ``jnp.linalg``'s failure mode.

``torch.linalg.cholesky`` and ``torch.linalg.inv`` raise on a matrix they
cannot factor, where ``jnp.linalg.cholesky`` and ``jnp.linalg.inv``
return NaN (or inf) and let the solve carry on.  The port's engines keep
the reference's behaviour: the ``_ex`` variants run without a check, and
a failed batch entry is filled with NaN.  No host sync: the fill is a
masked device op.
"""

from __future__ import annotations

import torch


def cholesky(z: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; a batch entry that is not positive definite
    comes out all-NaN instead of raising."""
    l, info = torch.linalg.cholesky_ex(z)
    return l.masked_fill_((info != 0)[..., None, None], float("nan"))


def inv(x: torch.Tensor) -> torch.Tensor:
    """Inverse; a batch entry that is exactly singular comes out all-NaN
    instead of raising."""
    xi, info = torch.linalg.inv_ex(x)
    return xi.masked_fill_((info != 0)[..., None, None], float("nan"))
