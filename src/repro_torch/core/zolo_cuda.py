"""Kernel-backed Zolo-PD: the ``zolo_cuda`` registry backend.

Port of ``repro/core/zolo_pallas.py`` (static half): binds the static
schedule source of the one Zolotarev engine (:mod:`repro_torch.core.zolo`)
to a :class:`~repro_torch.core.zolo.ZoloOps` bundle whose two hot loops
are the hand-written Hopper kernels:

* :func:`repro_torch.kernels.ops.gram`         — K1, fused shifted Gram.
* :func:`repro_torch.kernels.ops.polar_update` — K2, fused r-term combine.

On a CUDA iterate each op launches its kernel (or raises); on a CPU
iterate the same ops run the kernels' plain PyTorch versions, which is
how the CPU tests exercise this backend.  The dynamic binding
(``zolo_pd_pallas_dynamic``) waits for the dynamic engine.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import zolo as _zolo
from repro_torch.kernels import ops as _kops

# Table 1 keeps r <= 8: a leading dim up to this is a term stack
MAX_TERM_STACK = 8


def cuda_zolo_ops() -> _zolo.ZoloOps:
    """A :class:`~repro_torch.core.zolo.ZoloOps` bundle on K1 and K2.

    The kernels are 2-D.  The stacked r-term operands of CholeskyQR2's
    second-pass Gram ((r, m, n) Q factors, r <= 8) unroll onto K1 one
    term at a time, as the Pallas bundle does, so the kernel launch count
    follows the reference's structure (1 + 2r launches in a CholeskyQR2
    iteration at r > 1, 1 in a Cholesky one).  Each operand is made
    row-major before a launch: a no-op for the engine's own layouts
    (column-major solve results read through ``.mT``), an explicit copy
    for anything else.  f64 is not taken: the kernels accumulate in f32,
    and an f64 plan on ``zolo_cuda`` raises at plan time.
    """

    def gram(x, c=0.0):
        if x.ndim == 3 and x.shape[0] <= MAX_TERM_STACK:
            return torch.stack([gram(x[j], c) for j in range(x.shape[0])])
        if x.ndim != 2:
            raise ValueError(f"cuda_zolo_ops.gram takes (m, n) or an r-term "
                             f"stack (r <= {MAX_TERM_STACK}, m, n); got "
                             f"{tuple(x.shape)}")
        return _kops.gram(x.contiguous(), c)

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
                 hermitian_source=None, schedule=None):
    """Unrolled Zolo-PD (the contract of
    :func:`repro_torch.core.zolo.zolo_pd_static`) with the iteration's
    Gram products and r-term combine on K1 and K2.  Returns
    (Q, H or None, PolarInfo)."""
    return _zolo.zolo_pd_static(
        a, l0=l0, r=r, max_iters=max_iters, want_h=want_h,
        qr_mode=qr_mode, qr_iters=qr_iters,
        hermitian_source=hermitian_source, schedule=schedule,
        ops=cuda_zolo_ops())
