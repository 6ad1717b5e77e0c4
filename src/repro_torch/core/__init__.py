"""Numerics of the port: coefficients, norms, the static Zolo-PD engine,
the registry and the SVD assembly.  ``repro_torch.core.svd`` populates the
solver registry when imported (``repro_torch.solver`` does so)."""
