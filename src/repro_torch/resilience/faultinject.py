"""Deterministic fault injection for resilience testing.

Port of ``repro/resilience/faultinject.py``.  Two layers, matching the
two recovery layers:

* :func:`faulty_ops` wraps any :class:`repro_torch.core.zolo.ZoloOps`
  bundle — the plain ops, or the Hopper kernels' ``cuda_zolo_ops()`` —
  so a chosen iteration's output goes NaN, or a chosen Gram goes
  indefinite (the f32 kernel-envelope breakdown, reproduced on demand
  on any backend).  The wrapped bundle rides into a plan through
  ``SvdConfig.extra=(("ops", ops),)`` on ``zolo_static``/``zolo``, so the
  *production* escalation ladder is what recovers, not a test double.
* :class:`ServiceFaults` is the serving-layer fault plan (plain Python;
  the serving layer that reads it is not yet ported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.zolo import DEFAULT_OPS, ZoloOps


def faulty_ops(base: Optional[ZoloOps] = None, *,
               nan_at_iter: Optional[int] = None,
               indefinite_at_iter: Optional[int] = None,
               indefinite_shift: float = 1.0e6) -> ZoloOps:
    """Wrap ``base`` so a chosen call misbehaves.

    ``nan_at_iter=k`` NaNs the output of the k-th ``polar_update`` call —
    the one combine every driver calls exactly once per iteration, so k
    counts iterations in every mode.  ``indefinite_at_iter=k`` subtracts
    ``indefinite_shift * I`` from the k-th ``gram`` result, driving its
    Cholesky NaN exactly the way the f32 kernel envelope does.

    Indices count *calls* (execution is eager).  The reference counts
    traced call sites instead, so the two agree on static (unrolled)
    schedules, and on a dynamic driver at index 0 with its first mode
    pinned; there, the reference's index 1 is the ``while_loop`` body
    and poisons every later iteration, where here it poisons the second
    iteration only.  Each index fires at most once per bundle and the
    count runs on across calls, so a fault is *transient*: the ladder
    rung that retries with the same bundle sees healthy ops — the
    single-event upset model the escalation ladder is built for.  Each
    ``faulty_ops`` call returns a fresh bundle (closures compare by
    identity), so two injections never share a plan-cache entry.
    """
    base = DEFAULT_OPS if base is None else base
    calls = {"polar_update": 0, "gram": 0}

    def polar_update(x, t, a, mhat):
        k = calls["polar_update"]
        calls["polar_update"] += 1
        out = base.polar_update(x, t, a, mhat)
        if nan_at_iter is not None and k == nan_at_iter:
            out = out * float("nan")
        return out

    def gram(x, c=0.0):
        k = calls["gram"]
        calls["gram"] += 1
        g = base.gram(x, c)
        if indefinite_at_iter is not None and k == indefinite_at_iter:
            n = g.shape[-1]
            g = g - indefinite_shift * torch.eye(n, dtype=g.dtype,
                                                 device=g.device)
        return g

    return base._replace(polar_update=polar_update, gram=gram)


@dataclasses.dataclass(frozen=True)
class ServiceFaults:
    """Deterministic serving-layer fault plan (``ServiceConfig.faults``).

    * ``nan_request_seqs`` — submit sequence numbers whose batch slot is
      overwritten with NaNs at dispatch, while the request's retry rung
      is below ``nan_below_rung``.  With the default ``nan_below_rung=1``
      the rung-0 solve fails its health check but the first retry sees
      the clean input again — exercising ladder recovery end to end.  A
      value above the service's ``max_retries`` makes the request
      permanent poison and drives the quarantine path instead.
    * ``dispatch_error_batches`` — dispatch indices (0-based count of
      ``_dispatch`` calls) that raise ``RuntimeError(dispatch_error)``
      instead of launching, exercising batch-wide failure propagation.
    * ``clock_skew`` — seconds added to every service clock read;
      positive skew ages queued requests toward their deadlines.
    """

    nan_request_seqs: Tuple[int, ...] = ()
    nan_below_rung: int = 1
    dispatch_error_batches: Tuple[int, ...] = ()
    dispatch_error: str = "injected dispatch fault"
    clock_skew: float = 0.0
