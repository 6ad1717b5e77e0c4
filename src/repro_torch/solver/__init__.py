"""repro_torch.solver — the plan/execute SVD surface.

    cfg  = SvdConfig(method="zolo_cuda", kappa=9.06e3,
                     l0_policy="estimate_at_plan", r=4)
    p    = plan(cfg, a.shape, a.dtype)      # on the CUDA card
    u, s, vh = p.svd(a)

Port of ``repro.solver`` (dense single-device subset): see
:mod:`repro_torch.solver.planner`.
"""

from repro_torch.solver.config import SvdConfig
from repro_torch.solver.planner import (
    PlanResolution,
    SvdPlan,
    cache_stats,
    pin,
    plan,
    resolve_device,
    unpin,
)

__all__ = [
    "PlanResolution",
    "SvdConfig",
    "SvdPlan",
    "cache_stats",
    "pin",
    "plan",
    "resolve_device",
    "unpin",
]
