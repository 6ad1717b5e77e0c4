"""Paper Algorithm 3: grouped Zolo-PD over r process groups.

Port of ``repro/dist/grouped.py`` onto ``torch.distributed``.  The r
Zolotarev terms of eq. (12) are independent: term j needs only X and its
own shift c_{2j-1}.  The paper runs each term in its own process group
(the TOP context) over a ScaLAPACK grid (the SEP context) and combines
with DGSUM2D.  Here the same two levels are a grid of ranks,
``world = r * sep``, rank ``z * sep + s`` at (zolo index z, sep index s):

    zolo  (size r)    one group per Zolotarev term; the "zolo" process
                      group of a rank joins the ranks that hold the same
                      row block in every group
    sep   (size w/r)  the ranks inside one group; the iterate is split
                      row-wise over them, so a rank holds an (m/sep, n)
                      block and its term's Gram/QR work is distributed

Both drivers bind the one engine of :mod:`repro_torch.core.zolo` to the
collective ops of :mod:`repro_torch.dist.grouped_ops`; there is no
grouped iteration math here.

The programming model is SPMD, where the reference's is one controller:
every rank calls a driver (or a grouped plan) with the full input, as
the reference takes its global array, and gets the full result back,
identical on every rank: each rank slices its row block, the engine runs
on the block, and the blocks are gathered over the sep group once at the
end (zero pad rows sliced off).  A collective over a one-rank group is
an identity and is not issued: at sep = 1 no "sep" all-reduce and no
gather run, at r = 1 no "zolo" all-reduce (the reference psums over
every axis of the mesh, size 1 or not).

Every host decision of the engine — the dynamic loop's residual test,
the first iteration's regime and its l0 — derives from the result of a
collective (or from the identical input), so all ranks take the same
branch and the same number of iterations.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import coeffs as _coeffs
from repro_torch.core import norms as _norms
from repro_torch.core import zolo as _zolo
from repro_torch.core import zolo_cuda as _zolo_cuda
from repro_torch.core.qdwh import PolarInfo, upload
from repro_torch.dist import grouped_ops as _gops
from repro_torch.kernels import ref as _kref


@dataclasses.dataclass(frozen=True, eq=False)
class ZoloGroupMesh:
    """This rank's view of an (r, sep) grid of ranks.

    ``ranks[z][s]`` is the global rank at (zolo index z, sep index s);
    this rank sits at (``zolo_index``, ``sep_index``).  ``sep_group``
    joins the ranks of this rank's Zolotarev group (``ranks[zolo_index]``)
    and ``zolo_group`` the ranks at this rank's sep index in every group.
    ``device`` is where this rank computes.  Hashable by identity, so it
    keys the plan cache."""

    r: int
    sep: int
    zolo_index: int
    sep_index: int
    ranks: Tuple[Tuple[int, ...], ...]
    zolo_group: Any
    sep_group: Any
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"zolo": self.r, "sep": self.sep}

    def __repr__(self):
        return (f"ZoloGroupMesh(r={self.r}, sep={self.sep}, "
                f"zolo_index={self.zolo_index}, sep_index={self.sep_index}, "
                f"device={self.device})")


def zolo_group_mesh(r: int, group=None,
                    device=None) -> Optional[ZoloGroupMesh]:
    """The (r, sep = size / r) grid over the ranks of ``group`` (default:
    every rank of the default process group).

    Every rank of the default process group must call it, in the same
    order as its other ``new_group`` calls: each sub-group is created by
    all of them.  A rank outside ``group`` gets ``None``.  The backend is
    the default process group's.  ``device`` defaults to the current
    CUDA card (raising when there is none); pass ``"cpu"`` to compute on
    the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("zolo_group_mesh needs torch.distributed: call "
                           "init_process_group first")
    members = list(range(dist.get_world_size())) if group is None \
        else list(dist.get_process_group_ranks(group))
    ndev = len(members)
    if r < 1 or ndev % r != 0:
        divisors = [d for d in range(1, ndev + 1) if ndev % d == 0]
        raise ValueError(
            f"cannot split {ndev} ranks into r={r} Zolotarev groups; r "
            f"must divide the rank count (valid r for {ndev} ranks: "
            f"{divisors})")
    sep = ndev // r
    grid = tuple(tuple(members[z * sep + s] for s in range(sep))
                 for z in range(r))
    sep_groups = [dist.new_group(list(grid[z])) for z in range(r)]
    zolo_groups = [dist.new_group([grid[z][s] for z in range(r)])
                   for s in range(sep)]
    me = dist.get_rank()
    if me not in members:
        return None
    z, s = divmod(members.index(me), sep)
    if device is None:
        from repro_torch.solver.planner import resolve_device

        device = resolve_device(None)
    return ZoloGroupMesh(r=r, sep=sep, zolo_index=z, sep_index=s,
                         ranks=grid, zolo_group=zolo_groups[s],
                         sep_group=sep_groups[z],
                         device=torch.device(device))


def _mesh_layout(a, mesh, r: Optional[int], qr_mode: str, qr_iters: int,
                 first_iter_modes=(), mode_knob: str = "qr_mode"):
    """Mesh and shape validation shared by both drivers.  Returns (r,
    sep, m, n, m_pad): the row count padded with zero rows to a multiple
    of sep (zero rows are exact for every engine step: no Gram
    contribution, zero solve rows, zero through the combine)."""
    if a.ndim != 2:
        raise ValueError(f"grouped Zolo-PD takes one matrix; got shape "
                         f"{tuple(a.shape)}")
    if not isinstance(mesh, ZoloGroupMesh):
        raise ValueError(f"mesh must come from zolo_group_mesh(r); got "
                         f"{type(mesh).__name__}")
    if r is None:
        r = mesh.r
    if mesh.r != r:
        raise ValueError(f"mesh 'zolo' axis has size {mesh.r} != r={r}")
    _zolo._validate_iter_mode(mode_knob, qr_mode, extra=first_iter_modes)
    nsep = mesh.sep
    if nsep > 1 and qr_mode == "householder" and qr_iters > 0:
        raise ValueError(
            f"{mode_knob}='householder' needs the full iterate on every "
            f"rank (structured Householder QR is not row-distributed); "
            f"use a sep=1 mesh (r == ranks) or {mode_knob}='cholqr2'")
    if a.device != mesh.device:
        raise ValueError(f"the mesh computes on {mesh.device}; got a "
                         f"tensor on {a.device}")
    m, n = a.shape
    return r, nsep, m, n, m + (-m) % nsep


def _row_block(x, mesh: ZoloGroupMesh, m_pad: int):
    """This rank's (m_pad / sep, n) row block of ``x`` padded to m_pad
    rows, row-major."""
    n = x.shape[1]
    if m_pad != x.shape[0]:
        x = torch.cat([x, x.new_zeros((m_pad - x.shape[0], n))])
    rows = m_pad // mesh.sep
    block = x[mesh.sep_index * rows:(mesh.sep_index + 1) * rows]
    if block.shape != (rows, n):
        raise AssertionError(
            f"iterate not row-split over 'sep': local shape "
            f"{tuple(block.shape)}, expected ({rows}, {n}) (m_pad={m_pad}, "
            f"sep={mesh.sep})")
    return block.contiguous()


def _gather_rows(q, mesh: ZoloGroupMesh, m: int):
    """The full (m, n) iterate from every rank's block: one all-gather
    over the sep group (none at sep = 1), pad rows sliced off."""
    if mesh.sep == 1:
        return q[:m]
    rows, n = q.shape
    out = torch.empty((rows * mesh.sep, n), dtype=q.dtype, device=q.device)
    dist.all_gather(list(out.split(rows)), q.contiguous(),
                    group=mesh.sep_group)
    return out[:m]


def _group_ops(mesh: ZoloGroupMesh, x) -> _zolo.ZoloOps:
    """The grouped bundle: the sep collectives (sep > 1) under the term
    slice and the "zolo" combine.

    The local base follows the iterate alone: K1/K2
    (:func:`~repro_torch.core.zolo_cuda.cuda_zolo_ops`) for a CUDA
    iterate of itemsize <= 4 — every local Gram (the shifted Gram,
    CholeskyQR2's second-pass Grams, the dynamic driver's sigma_min Gram)
    on K1 and the combine on K2, the reference's policy for its Pallas
    kernels on the TPU — and the plain torch ops for a CPU iterate or an
    f64 one, for which no kernel exists.  No switch overrides the
    choice."""
    kernels = x.device.type == "cuda" and x.dtype.itemsize <= 4
    base = _zolo_cuda.cuda_zolo_ops() if kernels else _zolo.DEFAULT_OPS
    if mesh.sep > 1:
        base = _gops.sep_reduce_ops(base, group=mesh.sep_group,
                                    sep_index=mesh.sep_index)
    return _gops.zolo_term_group_ops(
        base, xw=1.0 if mesh.zolo_index == 0 else 0.0,
        group=mesh.zolo_group if mesh.r > 1 else None,
        zolo_index=mesh.zolo_index)


def grouped_zolo_pd_static(a, *, mesh: ZoloGroupMesh,
                           l0: Optional[float] = None,
                           r: Optional[int] = None, max_iters: int = 6,
                           qr_mode: str = "cholqr2", qr_iters: int = 1,
                           alpha=None, return_info: bool = False,
                           schedule=None, hh_block: int = 32):
    """Grouped (Alg. 3) Zolo-PD orthogonal factor of ``a`` (m >= n), the
    (static schedule, collective ops) binding of the engine.

    ``a`` has singular values in [l0 alpha, alpha] (alpha = 1 when
    omitted: pre-scaled).  ``mesh`` comes from :func:`zolo_group_mesh`
    with r groups; its sep > 1 splits each term's rows over the group's
    ranks.  ``qr_mode``/``qr_iters`` pick the first iterations' term as in
    ``zolo_pd_static`` ("householder" needs sep = 1).  A precomputed
    ``schedule`` takes precedence over ``l0``/``max_iters``.  The local
    ops follow the device and dtype (see :func:`_group_ops`).  Returns Q
    (or (Q, PolarInfo) with ``return_info``), the same on every rank;
    form H with :func:`repro_torch.core.qdwh.form_h`."""
    if schedule is not None and not len(schedule):
        raise ValueError("schedule= is empty: nothing to iterate")
    if r is None and schedule is not None:
        r = schedule[0].r
    r, nsep, m, n, m_pad = _mesh_layout(a, mesh, r, qr_mode, qr_iters)
    if schedule is not None:
        sched = list(schedule)
        if any(it.r != r for it in sched):
            raise ValueError(
                f"schedule order {[it.r for it in sched]} does not match "
                f"the mesh 'zolo' axis of size {r}")
    elif l0 is not None:
        sched = _coeffs.zolo_schedule_np(float(l0), r, max_iters=max_iters)
    else:
        raise ValueError("grouped Zolo-PD needs a static l0= or a "
                         "precomputed schedule=")
    cdt = _kref.accum_dtype(a.dtype)
    dev = a.device
    j = mesh.zolo_index
    # (iters, 1): this group's shift and weight per iteration
    c_grp = upload([[it.c[2 * j]] for it in sched], cdt, dev)
    a_grp = upload([[it.a[j]] for it in sched], cdt, dev)
    mhats = upload([it.mhat for it in sched], cdt, dev)
    x0 = a if alpha is None else a / torch.as_tensor(alpha, dtype=a.dtype,
                                                     device=dev)
    x = _row_block(x0, mesh, m_pad)
    del x0
    ops = _group_ops(mesh, x)
    q = _zolo.run_schedule(x, c_grp, a_grp, mhats, qr_mode=qr_mode,
                           qr_iters=qr_iters, ops=ops, hh_block=hh_block)
    del x
    q = _gather_rows(q, mesh, m)
    if not return_info:
        return q
    f32 = torch.float32
    return q, PolarInfo(
        iterations=torch.full((), len(sched), dtype=torch.int32, device=dev),
        residual=torch.zeros((), dtype=a.dtype, device=dev),
        l_final=torch.full((), sched[-1].l_after, dtype=f32, device=dev),
        converged=torch.ones((), dtype=torch.bool, device=dev),
        l_init=torch.full((), sched[0].l_before, dtype=f32, device=dev))


def grouped_zolo_pd_dynamic(a, *, mesh: ZoloGroupMesh,
                            r: Optional[int] = None, l=None, alpha=None,
                            max_iters: int = 8, first_mode: str = "auto",
                            eps: Optional[float] = None,
                            est_iters: int = 8, return_info: bool = False,
                            hh_block: int = 32):
    """Grouped (Alg. 3) Zolo-PD with run-time conditioning, the (dynamic
    schedule, collective ops) binding of the engine.

    ``alpha`` defaults to :func:`repro_torch.core.norms.sigma_max_upper`
    of the full ``a`` (the same on every rank).  The lower bound ``l``,
    when not given, is estimated sep-collectively: each rank forms the
    partial Gram of its row block, one "sep" all-reduce gives the global
    Gram, and :func:`repro_torch.core.norms.sigma_min_lower` runs
    replicated on it.  Each group takes its own term of the run-time
    coefficients (``coeff_select``), and the "zolo" combine gives the
    next iterate.  ``first_mode`` is "auto", "cholqr2", "chol", or
    "householder" on a sep = 1 mesh; under "auto" the extreme-regime
    first iteration is shifted CholeskyQR2 on a sep > 1 mesh.  Returns Q
    (or (Q, PolarInfo) with ``return_info``), the same on every rank."""
    r, nsep, m, n, m_pad = _mesh_layout(
        a, mesh, r, first_mode, qr_iters=1, first_iter_modes=("auto",),
        mode_knob="first_mode")
    dtype = a.dtype
    eps_f = eps or torch.finfo(_kref.accum_dtype(dtype)).eps
    alpha = _norms.sigma_max_upper(a) if alpha is None else \
        torch.as_tensor(alpha, device=a.device)
    x = _row_block(a / alpha.to(dtype), mesh, m_pad)
    ops = _group_ops(mesh, x)
    if l is None:
        l0 = _norms.sigma_min_lower(x, iters=est_iters, gram=ops.gram)
    elif isinstance(l, torch.Tensor):
        l0 = l.to(a.device)
    else:
        l0 = torch.tensor(float(l), dtype=torch.float64, device=a.device)
    l0 = torch.clamp(l0, 4 * eps_f, 1.0 - eps_f)
    q, l_fin, k, res, conv = _zolo.run_dynamic(
        x, l0, r, eps=eps_f, max_iters=max_iters, first_mode=first_mode,
        hh_block=hh_block, ops=ops, allow_householder=(nsep == 1))
    del x
    q = _gather_rows(q, mesh, m)
    if not return_info:
        return q
    return q, PolarInfo(
        iterations=torch.tensor(k, dtype=torch.int32, device=a.device),
        residual=res, l_final=l_fin, converged=conv,
        l_init=l0.to(torch.float32))


# the all-reduce cost charged per word until measured; the
# REPRO_COMM_FLOPS_PER_WORD environment variable overrides it at
# resolution time (see grouped_iteration_flops)
DEFAULT_COMM_FLOPS_PER_WORD = 32.0


def grouped_iteration_flops(m: int, n: int, r: int, iters: int,
                            gram_shared: bool, sep: int = 1,
                            comm_flops_per_word=None) -> float:
    """Flops (summed over the r groups, per rank within a group) of
    ``iters`` Cholesky-variant Zolotarev iterations on an m x n matrix.

    Per term: one n x n Cholesky (n^3/3, replicated on every rank of the
    group) and two triangular solves against the local row block
    (2 m n^2 / sep).  The Gram (2 m n^2 / sep locally, plus an n^2-word
    "sep" all-reduce) is paid once per group in the grouped mode and once
    per iteration in the single-address-space gram-shared mode (sep must
    be 1 there).  Collectives cost ``comm_flops_per_word`` flops a word:
    the n^2 "sep" Gram reduction and the (m n / sep) "zolo" combine.

    ``comm_flops_per_word=None`` resolves to the
    ``REPRO_COMM_FLOPS_PER_WORD`` environment variable when set, read at
    every call, else to :data:`DEFAULT_COMM_FLOPS_PER_WORD`."""
    if comm_flops_per_word is None:
        env = os.environ.get("REPRO_COMM_FLOPS_PER_WORD")
        comm_flops_per_word = (float(env) if env
                               else DEFAULT_COMM_FLOPS_PER_WORD)
    if sep < 1:
        raise ValueError(f"sep degree must be >= 1, got {sep}")
    if gram_shared and sep != 1:
        raise ValueError("gram_shared is the single-address-space mode; "
                         "the sep axis does not apply (got sep="
                         f"{sep})")
    gram = 2.0 * m * n * n / sep
    per_term = n ** 3 / 3.0 + 2.0 * m * n * n / sep
    if gram_shared:
        per_iter = gram + r * per_term
    else:
        comm = comm_flops_per_word * (
            (float(n * n) if sep > 1 else 0.0)      # "sep" Gram reduce
            + (m * n / sep if r > 1 else 0.0))      # "zolo" combine
        per_iter = r * (gram + per_term + comm)
    return float(iters * per_iter)
