"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

* ``gram``            — K1, fused shifted Gram ``G = A^T A + c I``
                        (``csrc/gram.cu``).
* ``grouped_combine`` — K2, fused r-term combine
                        ``Y = mhat (xw X + sum_j a_j T_j)``
                        (``csrc/grouped_combine.cu``); ``polar_update`` is
                        its xw = 1 form.
* ``matmul``          — K3, tiled matmul ``C = alpha A @ B`` with f32
                        accumulation (``csrc/matmul.cu``); off the solver
                        path, as in the reference: only ``ops.matmul``
                        reaches it.
* ``flash_attention`` — K4, causal flash attention over (b, s, h, d)
                        (``csrc/flash_attention.cu``); reached through
                        ``ops.flash_attention``.
* ``cholesky``        — K5, batched blocked Cholesky of f32 stacks
                        (``csrc/cholesky.cu``); ``core.linalg.cholesky``
                        routes CUDA stacks with n >= ``CHOLESKY_MIN_N``
                        to ``ops.cholesky``.

``ops`` holds the public wrappers: a CPU tensor goes to the plain
version in ``ref``, a CUDA tensor launches the kernel or raises.
Nothing is compiled at import; ``build`` runs ``nvcc`` at first launch.
"""
