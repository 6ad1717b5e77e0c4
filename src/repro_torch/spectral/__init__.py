"""repro_torch.spectral: partial-spectrum workloads over the plan/execute
stack.

Port of ``repro.spectral``.  Top-k / windowed SVD as a first-class
citizen: a frozen :class:`TopKConfig` resolves through :func:`plan_topk`
into a cached :class:`TopKPlan` whose strategies — randomized sketch
(:mod:`repro_torch.spectral.sketch`), spectral divide-and-conquer
(:mod:`repro_torch.spectral.dnc`), or dense-and-slice — all execute
through the :mod:`repro_torch.solver` registry backends.  See
:mod:`repro_torch.spectral.topk` for the strategy-selection contract.
"""

from repro_torch.spectral.dnc import (
    bisect_shift,
    count_above,
    dnc_flops,
    dnc_topk,
)
from repro_torch.spectral.sketch import (
    SKETCH_KINDS,
    gaussian_sketch,
    needed_power_iters,
    randomized_range,
    sketch_draw,
    sketch_flops,
    sketch_topk,
    srht_sketch,
    topk_residual,
)
from repro_torch.spectral.topk import (
    STRATEGIES,
    TopKConfig,
    TopKPlan,
    clear_topk_cache,
    plan_topk,
    topk_cache_stats,
    trace_count,
)

__all__ = [
    "SKETCH_KINDS",
    "STRATEGIES",
    "TopKConfig",
    "TopKPlan",
    "bisect_shift",
    "clear_topk_cache",
    "count_above",
    "dnc_flops",
    "dnc_topk",
    "gaussian_sketch",
    "needed_power_iters",
    "plan_topk",
    "randomized_range",
    "sketch_draw",
    "sketch_flops",
    "sketch_topk",
    "srht_sketch",
    "topk_cache_stats",
    "topk_residual",
    "trace_count",
]
