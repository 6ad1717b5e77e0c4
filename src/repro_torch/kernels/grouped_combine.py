"""K2: fused r-term combine ``Y = mhat (xw X + sum_j a_j T_j)`` — the CUDA
kernel's wrapper.

Replaces the Pallas TPU kernel
``src/repro/kernels/grouped_combine.py::_grouped_combine_kernel``
(``grouped_combine_kernel_call``; ``polar_update`` is its xw = 1 form).
The kernel is ``csrc/grouped_combine.cu``; its plain PyTorch version is
:func:`grouped_combine_plain` (``ref.grouped_combine_ref``).

What bounds it on the H100: bytes.  It reads X and the r terms once and
writes Y once: (r + 2) m n 4 B in f32, 3.46 GB at r = 4 and
m = n = 11,999, 1.03 ms at 3.35 TB/s (0.52 ms at r = 1); at ZoloMuon's
shapes (r = 2, m n <= 4.2 M) 2-67 MB, at or under the launch floor.  What
the design does about it: one grid-stride pass over the flat contiguous
arrays, coalesced along n, with 4-element vector accesses where every
base pointer is aligned (a masked scalar path otherwise).  A call is one
kernel launch and nothing else on the stream: the weights ``a`` are read
through a device pointer (taken as given when already a contiguous f32
tensor on the device), and mhat and xw each through a device pointer when
it is a tensor or as a launch argument when it is a python number, so a
launch never syncs the host to read a coefficient and never fills or
stacks a scalar first.

``launches`` counts kernel launches made through
:func:`grouped_combine_kernel_call` (``polar_update`` included).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import grouped_combine_ref

grouped_combine_plain = grouped_combine_ref  # the plain PyTorch version

# accumulation dtype of the kernel's sums, and where the conditioning
# envelope measured at it lives (kernel-accum-envelope lint)
COMBINE_ACCUM_DTYPE = torch.float32
COMBINE_KAPPA_ENVELOPE = "repro_torch.core.svd:CUDA_KAPPA_ENVELOPE"
COMBINE_DTYPES = (torch.float32, torch.bfloat16)
MAX_R = 8

launches = 0


def _scalar(v, device):
    """(device pointer or None, value) for a scalar argument of the
    kernel: a python number goes by value, a tensor by its f32 storage on
    ``device`` (converted only if it is not one already)."""
    if isinstance(v, torch.Tensor):
        if v.dtype != torch.float32 or v.device != device:
            v = v.to(device=device, dtype=torch.float32)
        if v.numel() != 1:
            raise ValueError(f"combine kernel takes one-element scalars, "
                             f"got shape {tuple(v.shape)}")
        return v, 0.0
    return None, float(v)


def grouped_combine_kernel_call(x: torch.Tensor, t: torch.Tensor, a, mhat,
                                xw=1.0) -> torch.Tensor:
    """Launch K2: Y = mhat * (xw * X + sum_j a[j] T[j]) in X's dtype.

    x: contiguous CUDA (m, n); t: contiguous (r, m, n), 1 <= r <= 8; each
    f32 or bf16.  ``a`` (r,) is a tensor on the same device or a sequence
    of numbers; ``mhat`` and ``xw`` each a one-element tensor or a python
    number.  One kernel launch a call.  Raises on anything the kernel does
    not take."""
    global launches
    dev = x.device
    if dev.type != "cuda" or t.device != dev:
        raise ValueError(f"combine kernel takes CUDA tensors on one device, "
                         f"got x on {dev}, t on {t.device}")
    if x.dtype not in COMBINE_DTYPES or t.dtype not in COMBINE_DTYPES:
        raise ValueError(f"combine kernel takes {COMBINE_DTYPES}, got x "
                         f"{x.dtype}, t {t.dtype}")
    if (x.ndim != 2 or t.ndim != 3 or t.shape[1] != x.shape[0]
            or t.shape[2] != x.shape[1]):
        raise ValueError(f"combine kernel takes x (m, n) and t (r, m, n), "
                         f"got {tuple(x.shape)} and {tuple(t.shape)}")
    r = t.shape[0]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"combine kernel takes 1 <= r <= {MAX_R}, got {r}")
    if not (x.is_contiguous() and t.is_contiguous()):
        raise ValueError("combine kernel needs contiguous x and t")
    if not (isinstance(a, torch.Tensor) and a.dtype == torch.float32
            and a.device == dev and a.is_contiguous()):
        a = torch.as_tensor(a, dtype=torch.float32,
                            device=dev).contiguous()
    if a.numel() != r:
        raise ValueError(f"combine kernel: {a.numel()} weights for "
                         f"r={r} terms")
    mhat_buf, mhat_v = _scalar(mhat, dev)
    xw_buf, xw_v = _scalar(xw, dev)
    y = torch.empty_like(x)
    code = _build.library("grouped_combine").zolo_grouped_combine(
        int(x.dtype == torch.bfloat16), int(t.dtype == torch.bfloat16),
        x.data_ptr(), t.data_ptr(), y.data_ptr(), x.numel(), r,
        a.data_ptr(), None if mhat_buf is None else mhat_buf.data_ptr(),
        mhat_v, None if xw_buf is None else xw_buf.data_ptr(), xw_v,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "combine kernel")
    launches += 1
    return y
