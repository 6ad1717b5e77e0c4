"""repro_torch — the PyTorch/CUDA port of the Zolo-SVD reproduction.

``src/repro`` (JAX/Pallas) is the reference; this package mirrors its
module and function names so each counterpart is easy to find.  It
imports ``torch``, numpy and scipy (mpmath for the extreme-conditioning
coefficients), never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``::

    import repro_torch.solver as S

    cfg = S.SvdConfig(method="zolo_cuda", kappa=9.06e3,
                      l0_policy="estimate_at_plan", r=4)
    u, s, vh = S.plan(cfg, a.shape, a.dtype).svd(a)

or in one call, on the input's device::

    q, h, info = repro_torch.polar_decompose(a, method="qdwh")
    u, s, vh = repro_torch.polar_svd(a, method="zolo", eig_method="jacobi")

The two hot loops of the Zolo-PD engine run on hand-written Hopper
kernels (``kernels/csrc``), built with ``nvcc`` at first use; on a CPU
tensor every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

# the one-call wrappers, imported on first use so that importing a
# submodule (the kernels, the configs) does not load the whole solver
_LAZY = ("polar_decompose", "polar_svd")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.core import svd as _svd

        return getattr(_svd, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
