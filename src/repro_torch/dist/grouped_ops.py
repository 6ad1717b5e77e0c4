"""Collective :class:`~repro_torch.core.zolo.ZoloOps` bundles: the grouped
(Algorithm 3) execution of the one Zolotarev engine as two ops layers.

Port of ``repro/dist/grouped_ops.py`` onto ``torch.distributed``
sub-groups.  Every rank runs the engine in its own process (SPMD), on
its own block of the iterate, and the collectives of these bundles are
the only coupling between ranks:

* :func:`sep_reduce_ops` — the intra-group distribution of one Zolotarev
  term (the paper's per-group SEP grid).  A rank holds an (m/sep, n) row
  block of the iterate; the Gram product is its one global quantity, so
  each rank forms the partial product of its block and one all-reduce
  over the group's "sep" ranks gives ``X^T X`` (PDSYRK + DGSUM2D).  The
  Cholesky factorizations run replicated on the n x n result, and the
  triangular solves and the combine are row-local.
* :func:`zolo_term_group_ops` — the inter-group "zolo" layer (the TOP
  context): a rank evaluates its group's one term, contributes
  ``mhat (xw X + a T)`` with ``xw`` one-hot over the groups, and one
  all-reduce over its "zolo" ranks (the ranks holding the same row block
  in every group) gives the next iterate.

Both wrap a base bundle that does the local work — the plain torch ops,
or K1/K2 (:func:`repro_torch.core.zolo_cuda.cuda_zolo_ops`) — and hand
the result to the engine's ``run_schedule``/``run_dynamic``.

The collectives are ``torch.distributed.all_reduce`` on the tensors as
they lie, under whatever backend the caller's default process group
has; the port never picks one.  Gloo stages a CUDA tensor through host
memory itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import zolo as _zolo
from repro_torch.kernels import ops as _kops
from repro_torch.kernels import ref as _kref


def sep_reduce_ops(base: Optional[_zolo.ZoloOps] = None, *, group,
                   sep_index: int) -> _zolo.ZoloOps:
    """A ZoloOps bundle whose ``gram``, ``fnorm`` and ``fnorm_pair``
    all-reduce over the "sep" process ``group``.

    ``gram``'s operand is this rank's (m/sep, n) row block and its result
    the global (n, n) Gram, the same on every rank of the group.  A
    nonzero shift is one-hotted onto the partial product of the rank at
    ``sep_index`` 0 (where the base gram also applies its shift clamp,
    against that rank's partial Gram), so the reduced result carries
    ``+ c I`` exactly once; a uniform shift would add ``c * sep``.
    ``gram_local`` stays the base's (CholeskyQR2's replicated identity
    block is never reduced), and ``polar_update`` is row-local.
    ``fnorm_pair`` reduces both residual sums of squares in one length-2
    all-reduce."""
    base = _zolo.DEFAULT_OPS if base is None else base

    def gram(x, c=0.0):
        # one-hot: only the shard at sep_index 0 carries the shift
        g = base.gram(x, c if sep_index == 0 else 0.0)
        dist.all_reduce(g, group=group)
        return g

    def fnorm(x):
        s = torch.sum(torch.abs(x) ** 2)
        dist.all_reduce(s, group=group)
        return torch.sqrt(s)

    def fnorm_pair(a, b):
        loc = torch.stack([torch.sum(torch.abs(a) ** 2),
                           torch.sum(torch.abs(b) ** 2)])
        dist.all_reduce(loc, group=group)
        return torch.sqrt(loc)

    return base._replace(gram=gram, fnorm=fnorm, fnorm_pair=fnorm_pair)


def zolo_term_group_ops(base: Optional[_zolo.ZoloOps] = None, *, xw: float,
                        group=None, zolo_index: int = 0) -> _zolo.ZoloOps:
    """Wrap ``base`` so that this rank evaluates its group's one
    Zolotarev term and the combine is a collective over the "zolo"
    process ``group``.

    * ``polar_update`` is the combine-with-DGSUM2D: this group's
      contribution ``mhat (xw X + sum_j a_j T_j)`` — K2
      (:func:`repro_torch.kernels.ops.grouped_combine`, its plain
      version on a CPU iterate) for an iterate of itemsize <= 4, the
      plain version for an f64 one, which no kernel takes — then one
      all-reduce over ``group``, whose result IS the next iterate.
      ``xw`` is 1.0 on the group at ``zolo_index`` 0 and 0.0 elsewhere,
      so exactly one group carries X (no 1/r rescale).  ``group=None``
      is a one-group mesh (r = 1): the contribution is the iterate and
      no collective is issued.
    * ``coeff_select`` takes this group's length-1 slice of the dynamic
      engine's (c_odd, a) (the static driver slices its schedule itself
      and never calls it).
    """
    base = _zolo.DEFAULT_OPS if base is None else base
    def polar_update(x, t, a, mhat):
        combine = _kops.grouped_combine if x.dtype.itemsize <= 4 else \
            _kref.grouped_combine_ref
        y = combine(x.contiguous(), t.contiguous(), a, mhat, xw)
        if group is not None:
            dist.all_reduce(y, group=group)
        return y

    def coeff_select(c_odd, a):
        j = zolo_index
        return c_odd[j:j + 1], a[j:j + 1]

    return base._replace(polar_update=polar_update,
                         coeff_select=coeff_select)
