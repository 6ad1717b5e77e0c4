"""Numerics of the port: coefficients, norms, the Zolo-PD engine and its
QDWH/Newton baselines, the structured Householder QR, the eigensolvers,
the registry and the SVD assembly.  Importing the package populates the
solver registry (``repro_torch.core.svd`` registers the backends).

``polar_decompose`` / ``polar_svd`` are thin wrappers over the
plan/execute surface in :mod:`repro_torch.solver`; hold a plan for
repeated solves.
"""

from repro_torch.core.coeffs import (
    choose_r,
    qdwh_coeffs,
    qdwh_iter_count,
    qdwh_schedule_np,
    zolo_coeffs,
    zolo_coeffs_np,
    zolo_fn_product,
    zolo_fn_scalar,
    zolo_iter_count,
    zolo_schedule_np,
)
from repro_torch.core.eig import (
    block_jacobi_eigh,
    eigh,
    padded_block_jacobi_eigh,
)
from repro_torch.core.newton import scaled_newton_pd
from repro_torch.core.norms import (
    condition_estimate,
    sigma_max_power,
    sigma_max_upper,
    sigma_min_lower,
    sigma_min_lower_qr,
    singular_interval,
)
from repro_torch.core.qdwh import PolarInfo, form_h, qdwh_pd, qdwh_pd_static
from repro_torch.core.registry import (
    EigSpec,
    PolarSpec,
    get_eig,
    get_polar,
    list_eig,
    list_polar,
    register_eig,
    register_polar,
    unregister_eig,
    unregister_polar,
)
from repro_torch.core.structured_qr import (
    cholesky_qr2,
    dense_stacked_qr_q1q2,
    structured_qr_factor,
    structured_qr_flops,
    structured_qr_q1q2,
)
from repro_torch.core.svd import (
    jacobi_svd,
    orthogonality,
    polar_decompose,
    polar_svd,
    svd_residual,
)
from repro_torch.core.zolo import (
    DEFAULT_OPS,
    ZoloOps,
    polar_canonical,
    run_dynamic,
    run_schedule,
    zolo_iteration,
    zolo_pd,
    zolo_pd_static,
)
from repro_torch.core.zolo_cuda import (
    cuda_zolo_ops,
    zolo_pd_cuda,
    zolo_pd_cuda_dynamic,
)

__all__ = [k for k in dir() if not k.startswith("_")]
