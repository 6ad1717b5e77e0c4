"""repro_torch.serve — the SVD-serving engine and the LM serving engine.

Port of ``repro.serve``.  :mod:`repro_torch.serve.engine` is the LM
``ServeEngine`` (prefill, the decode loop, sampling).
:mod:`repro_torch.serve.svd_service` is the
solver-facing subsystem: bucketed plan pool + continuous micro-batching
over :mod:`repro_torch.solver` plans, with verified solves, retry
ladders, deadlines, shedding and circuit breakers (see that module's
docstring).  The typed serving errors live in
:mod:`repro_torch.resilience.errors` and are re-exported here.
"""

from repro_torch.resilience.errors import (Backpressure, CircuitOpen,
                                           DeadlineExceeded, FutureTimeout,
                                           SolveFailure)
from repro_torch.resilience.faultinject import ServiceFaults
from repro_torch.serve.bucketing import BucketKey, BucketPolicy
from repro_torch.serve.engine import (ServeEngine, make_decode_fn,
                                      make_prefill_fn, sample)
from repro_torch.serve.scheduler import MicroBatchScheduler
from repro_torch.serve.svd_service import (
    DEFAULT_MODES,
    ServiceConfig,
    SvdFuture,
    SvdService,
    topk_mode_k,
)

__all__ = [
    "Backpressure",
    "BucketKey",
    "BucketPolicy",
    "CircuitOpen",
    "DEFAULT_MODES",
    "DeadlineExceeded",
    "FutureTimeout",
    "MicroBatchScheduler",
    "ServeEngine",
    "ServiceConfig",
    "ServiceFaults",
    "SolveFailure",
    "SvdFuture",
    "SvdService",
    "make_decode_fn",
    "make_prefill_fn",
    "sample",
    "topk_mode_k",
]
