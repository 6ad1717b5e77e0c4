"""Shape/dtype bucketing for SVD serving: the padded plan-key ladder.

Port of ``repro/serve/bucketing.py``.  A request stream carries
arbitrary (m, n) problems, but plan reuse needs a SMALL set of (shape,
dtype, config) keys.  The bridge is a geometric size ladder: every
request is canonically oriented (rows >= cols; wide inputs transpose in
and their factors transpose back out), zero-padded up to the next rung
(M, N), and solved through the ONE plan for that rung.  The spectrum is
then masked back out of the padded factors.

Why zero padding is *exact* here, in two steps:

* **Zero rows** change nothing: the Gram X^T X — the only way the
  iteration touches the row space — is unchanged, so every singular
  value and right vector is identical and the extra left rows stay
  exactly zero.  This is the same padding :mod:`repro_torch.dist.grouped`
  uses when it rounds m up to a multiple of the "sep" axis.
* **Zero columns** inject exactly (N - n) *zero* singular values.  The
  composed Zolotarev (and QDWH) map is an odd rational function with
  f(0) = 0, so the injected values stay exactly 0 through every polar
  iteration (the shifted Gram G + cI remains positive definite — c > 0
  — so no factorization ever fails), the H-stage sees a block-diagonal
  H = diag(H_A, 0), and the descending sort parks the injected zeros at
  the tail of the spectrum.  :func:`unpad_svd` slices them off.

The measured cost of padding is the pad-waste fraction
(:func:`pad_waste`): the fraction of batched work spent on zeros.  The
ladder's ``growth`` trades that waste against the number of live plans.

Plain tensor code: the reference jits the per-entry unpad to save
dispatches (``unpad_svd_entry``); here the ``_entry`` forms are the same
eager ops on one batch entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import registry as _registry


def dtype_name(dtype) -> str:
    """The bare dtype name a :class:`BucketKey` carries ("float32"), for
    a torch dtype, a name, or anything with a ``name``/``dtype``."""
    if isinstance(dtype, str):
        dt = getattr(torch, dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype name {dtype!r}")
        return _registry.dtype_name(dt)
    return _registry.dtype_name(getattr(dtype, "dtype", dtype))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a :class:`BucketKey`'s dtype name."""
    return getattr(torch, dtype_name(name))


class BucketKey(NamedTuple):
    """One padded plan key: everything that selects a plan.

    ``m_pad >= n_pad`` always (canonical orientation); ``dtype`` is the
    request dtype's bare name ("float32", as in the reference, so keys
    compare equal across the packages); ``mode`` is the service
    accuracy-mode tag (it selects the plan's kappa hint / schedule
    depth, so two modes at one padded shape are two plans).
    """

    m_pad: int
    n_pad: int
    dtype: str
    mode: str


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Geometric size ladder: rungs are ``base * ceil(growth^k)``.

    ``base`` floors the smallest rung (tiny problems share one bucket
    instead of one plan each); ``growth`` bounds per-dimension
    overpadding at ``growth``x, i.e. the worst-case pad-waste fraction
    of a single request at ``1 - 1/growth^2`` — the default 1.5 ladder
    (32, 48, 72, 108, 162, 243, ...) caps it at ~55% while keeping the
    rung count logarithmic in the served shape range.
    """

    base: int = 32
    growth: float = 1.5

    def __post_init__(self):
        if self.base < 1:
            raise ValueError(f"bucket base must be >= 1, got {self.base}")
        if self.growth <= 1.0:
            raise ValueError(
                f"bucket growth must be > 1 (the ladder must climb), "
                f"got {self.growth}")

    def rung(self, size: int) -> int:
        """Smallest ladder rung >= size."""
        if size < 1:
            raise ValueError(f"bucketed dimensions are >= 1, got {size}")
        s = self.base
        while s < size:
            s = int(math.ceil(s * self.growth))
        return s

    def key_for(self, shape: Tuple[int, int], dtype, mode: str) -> BucketKey:
        """The padded plan key serving a (m, n) request.

        Orientation-free: (m, n) and (n, m) land in the same bucket
        (the service transposes wide inputs to canonical rows >= cols
        before padding).
        """
        m, n = int(shape[0]), int(shape[1])
        if m < n:
            m, n = n, m
        return BucketKey(self.rung(m), self.rung(n), dtype_name(dtype),
                         str(mode))


def canonicalize(a):
    """(a_canonical, transposed) with rows >= cols.

    Same convention as ``repro_torch.core.zolo.polar_canonical``; the
    service applies it *before* padding so every bucket is tall and
    :func:`unpad_svd` undoes it after masking.
    """
    m, n = a.shape[-2], a.shape[-1]
    if m >= n:
        return a, False
    return a.mT, True


def pad_to_bucket(a, m_pad: int, n_pad: int):
    """Zero-pad a canonical (m, n) matrix to the (m_pad, n_pad) rung."""
    m, n = a.shape[-2], a.shape[-1]
    if m > m_pad or n > n_pad:
        raise ValueError(f"matrix {tuple(a.shape)} does not fit bucket "
                         f"({m_pad}, {n_pad})")
    if (m, n) == (m_pad, n_pad):
        return a
    return torch.nn.functional.pad(a, (0, n_pad - n, 0, m_pad - m))


def unpad_svd(u, s, vh, m: int, n: int, transposed: bool):
    """Mask the padded spectrum back out of a bucket-shaped SVD.

    ``u`` (m_pad, n_pad) / ``s`` (n_pad,) / ``vh`` (n_pad, n_pad) are
    the padded solve of a canonical (m, n) request.  The n genuine
    singular triplets must be *identified by padded index, not by
    value*: the injected triplets' values are exactly 0 (see the module
    docstring), but a rank-deficient request has genuine zeros too, and
    the descending sort breaks those ties arbitrarily — slicing the
    first n entries could then keep an injected triplet (a padded-
    column basis vector, zero everywhere the request lives) and drop a
    genuine null-space vector.  The discriminator is right-vector mass
    on the request's own columns: genuine vectors carry all of it,
    injected ones exactly none, so a stable partition by that mask
    selects the n genuine triplets while preserving the descending
    value order.  For a transposed (originally wide) request the
    factors swap back: A = (U S Vh)^T = V S U^T.
    """
    n_pad = s.shape[-1]
    if n_pad != n:
        mass = torch.sum(vh[..., :n].float() ** 2, dim=-1)
        # 0 = genuine (mass ~ 1), 1 = injected (mass exactly 0); stable
        # argsort keeps the descending-s order within each class
        idx = torch.argsort((mass < 0.5).to(torch.int32), dim=-1,
                            stable=True)[..., :n]
        s = torch.take_along_dim(s, idx, dim=-1)
        u = torch.take_along_dim(u, idx[..., None, :], dim=-1)
        vh = torch.take_along_dim(vh, idx[..., :, None], dim=-2)
    u = u[..., :m, :n]
    s = s[..., :n]
    vh = vh[..., :n, :n]
    if transposed:
        return vh.mT, s, u.mT
    return u, s, vh


def unpad_topk(u, s, vh, m: int, n: int, k: int, transposed: bool):
    """Mask padding out of a bucket-shaped *top-k* solve.

    ``u`` (m_pad, k) / ``s`` (k,) / ``vh`` (k, n_pad) from the padded
    top-k of a canonical (m, n) request.  Padding exactness carries
    over from the full case: zero rows leave the Gram unchanged and
    zero columns inject exactly-zero singular values, which a top-k
    solve with k <= n (validated at submit) never ranks above a genuine
    nonzero triplet.  (When k exceeds the request's *rank*, trailing
    s = 0 triplets may point anywhere in the padded null space — their
    sliced right vectors are then not unit norm, but they carry zero
    weight in any reconstruction.)
    """
    u = u[..., :m, :k]
    s = s[..., :k]
    vh = vh[..., :k, :n]
    if transposed:
        return vh.mT, s, u.mT
    return u, s, vh


def unpad_svd_entry(u_b, s_b, vh_b, i: int, m: int, n: int,
                    transposed: bool):
    """Batch entry ``i``'s :func:`unpad_svd`."""
    return unpad_svd(u_b[i], s_b[i], vh_b[i], m, n, transposed)


def unpad_topk_entry(u_b, s_b, vh_b, i: int, m: int, n: int, k: int,
                     transposed: bool):
    """Batch entry ``i``'s :func:`unpad_topk`."""
    return unpad_topk(u_b[i], s_b[i], vh_b[i], m, n, k, transposed)


def pad_waste(shapes, m_pad: int, n_pad: int, slots: int) -> float:
    """Fraction of a dispatched (slots, m_pad, n_pad) batch spent on
    padding: 1 - useful/total, counting empty slots as pure waste."""
    useful = sum(min(m, n) * max(m, n) for m, n in shapes)
    total = slots * m_pad * n_pad
    return 1.0 - useful / total if total else 0.0
