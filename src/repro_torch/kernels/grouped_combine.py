"""K2: fused r-term combine ``Y = mhat (xw X + sum_j a_j T_j)`` — the CUDA
kernel's wrapper.

Replaces the Pallas TPU kernel
``src/repro/kernels/grouped_combine.py::_grouped_combine_kernel``
(``grouped_combine_kernel_call``; ``polar_update`` is its xw = 1 form).
The kernel is ``csrc/grouped_combine.cu``; its plain PyTorch version is
:func:`grouped_combine_plain` (``ref.grouped_combine_ref``).

What bounds it on the H100: bytes.  It reads X and the r terms once and
writes Y once: (r + 2) m n 4 B in f32, 3.46 GB at r = 4 and
m = n = 11,999, 1.03 ms at 3.35 TB/s (0.52 ms at r = 1).  What the design
does about it: one grid-stride pass over the flat contiguous arrays,
coalesced along n, with 4-element vector accesses where every base
pointer is aligned (a masked scalar path otherwise); the weights ``a``
and the scalars mhat and xw are read from device memory, so a launch
never syncs the host to read a coefficient.

``launches`` counts kernel launches made through
:func:`grouped_combine_kernel_call` (``polar_update`` included).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ref import grouped_combine_ref

grouped_combine_plain = grouped_combine_ref  # the plain PyTorch version

COMBINE_ACCUM_DTYPE = torch.float32
COMBINE_DTYPES = (torch.float32, torch.bfloat16)
MAX_R = 8

launches = 0


def _device_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def grouped_combine_kernel_call(x: torch.Tensor, t: torch.Tensor, a, mhat,
                                xw=1.0) -> torch.Tensor:
    """Launch K2: Y = mhat * (xw * X + sum_j a[j] T[j]) in X's dtype.

    x: contiguous CUDA (m, n); t: contiguous (r, m, n), 1 <= r <= 8; each
    f32 or bf16.  ``a`` (r,), ``mhat`` and ``xw`` are tensors on the same
    device or python numbers.  Raises on anything the kernel does not
    take."""
    global launches
    if x.device.type != "cuda" or t.device != x.device:
        raise ValueError(f"combine kernel takes CUDA tensors on one device, "
                         f"got x on {x.device}, t on {t.device}")
    if x.dtype not in COMBINE_DTYPES or t.dtype not in COMBINE_DTYPES:
        raise ValueError(f"combine kernel takes {COMBINE_DTYPES}, got x "
                         f"{x.dtype}, t {t.dtype}")
    if x.ndim != 2 or t.ndim != 3 or tuple(t.shape[1:]) != tuple(x.shape):
        raise ValueError(f"combine kernel takes x (m, n) and t (r, m, n), "
                         f"got {tuple(x.shape)} and {tuple(t.shape)}")
    r = t.shape[0]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"combine kernel takes 1 <= r <= {MAX_R}, got {r}")
    if not (x.is_contiguous() and t.is_contiguous()):
        raise ValueError("combine kernel needs contiguous x and t")
    dev = x.device
    a_buf = torch.as_tensor(a, dtype=torch.float32, device=dev).reshape(-1)
    if a_buf.numel() != r:
        raise ValueError(f"combine kernel: {a_buf.numel()} weights for "
                         f"r={r} terms")
    a_buf = a_buf.contiguous()
    s_buf = torch.stack([_device_f32(mhat, dev), _device_f32(xw, dev)])
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    lib = _build.library("grouped_combine")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.zolo_grouped_combine(
        int(x.dtype == torch.bfloat16), int(t.dtype == torch.bfloat16),
        x.data_ptr(), t.data_ptr(), y.data_ptr(), x.numel(), r,
        a_buf.data_ptr(), s_buf.data_ptr(), stream)
    _build.check(code, "combine kernel")
    launches += 1
    return y
