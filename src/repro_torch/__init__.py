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

The two hot loops of the static Zolo-PD engine run on hand-written
Hopper kernels (``kernels/csrc``), built with ``nvcc`` at first use; on a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
