"""Typed failure surface of the resilience layer.

Port of ``repro/resilience/errors.py`` (plain Python, copied).  Every
recovery path in :mod:`repro_torch.resilience` ends in exactly one of
two places: a healthy result, or one of these exceptions (the serving
layer, not yet ported, raises the last four).  Nothing times out
silently, nothing hangs, and nothing surfaces a bare ``RuntimeError`` a
caller would have to string-match — a client switches on the type:

* :class:`SolveFailure`     — the escalation ladder ran out of rungs;
  carries the full verdict trail (one
  :class:`~repro_torch.resilience.escalate.RungAttempt` per rung tried)
  so the failure is diagnosable post hoc.
* :class:`DeadlineExceeded` — a request's deadline passed before its
  batch dispatched (or before its retry could run).
* :class:`Backpressure`     — the service shed the request at submit
  time because the queue depth was at its limit; the client should
  back off and resubmit.
* :class:`CircuitOpen`      — the request's bucket has failed
  repeatedly and its circuit breaker is cooling down; submits to other
  buckets are unaffected.
* :class:`FutureTimeout`    — ``SvdFuture.result(timeout=...)`` gave up
  waiting; the request itself is still in flight and the future can be
  waited on again.
"""

from __future__ import annotations

from typing import Tuple


class ResilienceError(Exception):
    """Base class for every typed failure the resilience layer raises."""


class SolveFailure(ResilienceError):
    """Every rung of the escalation ladder was tried and none produced a
    healthy solve.  ``trail`` holds the per-rung record — config, escalation
    reason, and the health verdict (or plan error) that failed it."""

    def __init__(self, trail: Tuple = (), message: str = ""):
        self.trail = tuple(trail)
        if not message:
            steps = "; ".join(
                f"[{t.rung}] {t.reason}: {t.outcome}"
                + (f" ({t.error})" if t.error else "")
                + (f" ({', '.join(t.verdict.reasons)})"
                   if getattr(t, "verdict", None) is not None
                   and t.verdict.reasons else "")
                for t in self.trail)
            message = (f"no escalation rung produced a healthy solve "
                       f"({len(self.trail)} tried: {steps})"
                       if self.trail else
                       "no escalation rung produced a healthy solve")
        super().__init__(message)


class DeadlineExceeded(ResilienceError):
    """The request's deadline passed before it could be (re)dispatched."""


class Backpressure(ResilienceError):
    """Submit-time load shed: the service queue is at its depth limit."""


class CircuitOpen(ResilienceError):
    """The request's bucket breaker is open after repeated plan failures;
    retry after the cooldown."""


class FutureTimeout(ResilienceError):
    """``SvdFuture.result(timeout=)`` expired; the request is still live
    and the future remains waitable."""
