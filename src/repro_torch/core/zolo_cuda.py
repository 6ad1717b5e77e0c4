"""Kernel-backed Zolo-PD: the ``zolo_cuda`` and ``zolo_cuda_dynamic``
registry backends.

Port of ``repro/core/zolo_pallas.py``: binds both schedule sources of the
one Zolotarev engine (:mod:`repro_torch.core.zolo`) — the static
precomputed schedule (:func:`zolo_pd_cuda`) and the dynamic run-time
coefficients (:func:`zolo_pd_cuda_dynamic`) — to a
:class:`~repro_torch.core.zolo.ZoloOps` bundle whose two hot loops are
the hand-written Hopper kernels:

* :func:`repro_torch.kernels.ops.gram`         — K1, fused shifted Gram.
* :func:`repro_torch.kernels.ops.polar_update` — K2, fused r-term combine.

On a CUDA iterate each op launches its kernel (or raises); on a CPU
iterate the same ops run the kernels' plain PyTorch versions, which is
how the CPU tests exercise these backends.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import zolo as _zolo
from repro_torch.kernels import gram as _kgram
from repro_torch.kernels import ops as _kops

# Table 1 keeps r <= 8: a leading dim up to this is a term stack
MAX_TERM_STACK = 8


def cuda_zolo_ops() -> _zolo.ZoloOps:
    """A :class:`~repro_torch.core.zolo.ZoloOps` bundle on K1 and K2.

    The kernels are 2-D.  The stacked r-term operands of CholeskyQR2's
    second-pass Gram ((r, m, n) Q factors, r <= 8) unroll onto K1 one
    term at a time, as the Pallas bundle does, so the kernel launch count
    follows the reference's structure (1 + 2r launches in a CholeskyQR2
    iteration at r > 1, 1 in a Cholesky one, none in a structured
    Householder one, whose QRs are torch ops; K2 once per iteration).
    Both K1 routes read an operand of either major as it lies (the
    engine's column-major solve results, read through ``.mT``): the bf16
    route stages it at most once, the f32 route reads it in place or
    copies it row-major once inside the wrapper (unsplit, with no float4
    columns: :func:`repro_torch.kernels.gram.gram_f32_operand`), so only
    an f32 operand of other strides is made contiguous here.  K2 takes
    row-major operands, made contiguous first (a no-op for a row-major
    one).  f64 is not taken: the kernels accumulate in f32, and an f64
    plan on ``zolo_cuda`` raises at plan time.
    """

    def gram(x, c=0.0):
        if x.ndim == 3 and x.shape[0] <= MAX_TERM_STACK:
            return torch.stack([gram(x[j], c) for j in range(x.shape[0])])
        if x.ndim != 2:
            raise ValueError(f"cuda_zolo_ops.gram takes (m, n) or an r-term "
                             f"stack (r <= {MAX_TERM_STACK}, m, n); got "
                             f"{tuple(x.shape)}")
        if _kgram.gram_route(x) == "simt" and _kgram.gram_layout(x) is None:
            x = x.contiguous()
        return _kops.gram(x, c)

    def polar_update(x, t, a, mhat):
        if x.ndim != 2:
            raise ValueError(f"cuda_zolo_ops.polar_update takes a 2-D "
                             f"iterate; got {tuple(x.shape)}")
        return _kops.polar_update(x.contiguous(), t.contiguous(), a, mhat)

    # single address space: a replicated operand's Gram is the same op
    return _zolo.ZoloOps(gram=gram, polar_update=polar_update,
                         gram_local=gram)


def zolo_pd_cuda(a, *, l0: Optional[float] = None, r: Optional[int] = None,
                 max_iters: int = 6, want_h: bool = False,
                 qr_mode: str = "cholqr2", qr_iters: int = 1,
                 hermitian_source=None, schedule=None, hh_block: int = 32,
                 ops: Optional[_zolo.ZoloOps] = None):
    """Unrolled Zolo-PD (the contract of
    :func:`repro_torch.core.zolo.zolo_pd_static`) with the iteration's
    Gram products and r-term combine on K1 and K2 (a Householder
    iteration's structured QRs are torch ops; its combine is K2).
    ``ops`` replaces the kernel bundle (a wrapper of
    :func:`cuda_zolo_ops`, e.g. one that reduces over ranks).
    Returns (Q, H or None, PolarInfo)."""
    return _zolo.zolo_pd_static(
        a, l0=l0, r=r, max_iters=max_iters, want_h=want_h,
        qr_mode=qr_mode, qr_iters=qr_iters,
        hermitian_source=hermitian_source, schedule=schedule,
        ops=cuda_zolo_ops() if ops is None else ops, hh_block=hh_block)


def zolo_pd_cuda_dynamic(a, r: int = 3, *, alpha=None, l=None,
                         max_iters: int = 8, eps=None, want_h: bool = True,
                         first_mode: str = "auto", hh_block: int = 32):
    """Dynamic Zolo-PD (the contract of
    :func:`repro_torch.core.zolo.zolo_pd`) with the iteration's Gram
    products and r-term combine on K1 and K2 inside the residual-stopped
    loop.  Returns (Q, H or None, PolarInfo)."""
    return _zolo.zolo_pd(a, r, alpha=alpha, l=l, max_iters=max_iters,
                         eps=eps, want_h=want_h, first_mode=first_mode,
                         hh_block=hh_block, ops=cuda_zolo_ops())
