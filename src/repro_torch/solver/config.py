"""SvdConfig: the frozen, hashable description of one solver configuration.

Port of ``repro/solver/config.py`` with the same fields, defaults and
validation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

MODES = ("auto", "static", "dynamic", "grouped")
L0_POLICIES = ("given", "estimate_at_plan", "runtime")
SCALES = ("none", "power", "bound")
# the floating dtypes a plan may factorize in, by name
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class SvdConfig:
    """Frozen solver configuration; hashable, so it keys the plan cache.

    method       registry polar backend name, or "auto" (capability flags
                 + per-spec ``flops_fn`` cost model pick the cheapest).
    eig_method   registry eigensolver for the H stage of Algorithm 2.
    mode         "static" (precomputed schedule), "dynamic" (run-time
                 coefficients and a residual stop), "grouped" (Algorithm
                 3 over a ``zolo_group_mesh``), or "auto": grouped when
                 the plan has a mesh, else dynamic when ``l0_policy`` is
                 "runtime", else static; with an explicit method, "auto"
                 follows that backend's nature.
    r            Zolotarev order; None picks it from the conditioning per
                 paper Table 1 (``choose_r``).
    l0           lower bound on sigma_min of the (pre-scaled) input.
    l0_policy    "given" (use ``l0``), "estimate_at_plan"
                 (``l0 = 0.9 / kappa``) or "runtime" (a dynamic backend
                 estimates the bound on the device; ``l0`` must be None).
    kappa        condition-number hint (auto scoring, r choice, l0).
    max_iters    schedule length cap; None keeps the backend default.
    qr_mode      first-iteration factorization ("cholqr2" | "householder"
                 | "chol"; a dynamic backend also takes "auto"); None:
                 the backend's default ("cholqr2" static, "auto" dynamic:
                 structured Householder below l0 = 10 sqrt(eps),
                 CholeskyQR2 below 0.05, Cholesky above).
    qr_iters     how many leading iterations use ``qr_mode`` (default 1).
    nb           block size for a block-Jacobi eigensolver.
    scale        pre-scaling by the plan for precomputed-schedule
                 backends (dynamic ones scale themselves): "power"
                 (1.05x power-iteration estimate, the default), "bound"
                 (guaranteed sqrt(norm1 * norminf) cap) or "none" (the
                 caller guarantees sigma_max <= 1).
    compute_dtype  factorize in this dtype (a name in
                 :data:`COMPUTE_DTYPES`), cast results back to the plan
                 dtype; None computes in the input dtype.
    extra        extra backend kwargs as a sorted tuple of (name, value)
                 pairs (hashable passthrough).
    """

    method: str = "auto"
    eig_method: str = "eigh"
    mode: str = "auto"
    r: Optional[int] = None
    l0: Optional[float] = None
    l0_policy: str = "given"
    kappa: Optional[float] = None
    max_iters: Optional[int] = None
    qr_mode: Optional[str] = None
    qr_iters: Optional[int] = None
    nb: int = 32
    scale: str = "power"
    compute_dtype: Optional[str] = None
    extra: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r} not in {MODES}")
        if self.l0_policy not in L0_POLICIES:
            raise ValueError(
                f"l0_policy={self.l0_policy!r} not in {L0_POLICIES}")
        if self.scale not in SCALES:
            raise ValueError(f"scale={self.scale!r} not in {SCALES}")
        if self.l0_policy == "runtime" and self.l0 is not None:
            raise ValueError("l0_policy='runtime' estimates the bound "
                             "in-graph; leave l0=None (or use 'given')")
        if self.compute_dtype is not None and \
                self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype={self.compute_dtype!r} not in "
                             f"{tuple(COMPUTE_DTYPES)}")
        extra = self.extra
        if isinstance(extra, dict):
            extra = extra.items()
        extra = tuple(sorted((str(k), v) for k, v in extra))
        try:
            hash(extra)
        except TypeError:
            raise ValueError(
                "SvdConfig.extra must be hashable (configs key the plan "
                f"cache): {extra!r}") from None
        object.__setattr__(self, "extra", extra)

    def replace(self, **changes) -> "SvdConfig":
        """A copy with the given fields replaced (configs are frozen)."""
        return dataclasses.replace(self, **changes)
