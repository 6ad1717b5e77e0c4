"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

* ``gram``            — K1, fused shifted Gram ``G = A^T A + c I``
                        (``csrc/gram.cu``).
* ``grouped_combine`` — K2, fused r-term combine
                        ``Y = mhat (xw X + sum_j a_j T_j)``
                        (``csrc/grouped_combine.cu``); ``polar_update`` is
                        its xw = 1 form.

``ops`` holds the public wrappers: a CPU tensor goes to the plain
version in ``ref``, a CUDA tensor launches the kernel or raises.
Nothing is compiled at import; ``build`` runs ``nvcc`` at first launch.
"""
