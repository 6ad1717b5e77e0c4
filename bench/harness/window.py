"""The measured window: a closed loop of one caller, and in a traced run
the profiler over a short steady part of it."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from harness import trace as _trace

TRACE_ATTEMPTS = 3  # traced parts tried before a run gives up on a trace


@dataclasses.dataclass
class Context:
    """What an entry is given: the run's arguments, the cell's
    configuration, mix and reference, and the spans of a traced run."""

    torch: object
    device: object
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    reference: object
    spans: Optional[_trace.Spans]
    log: Callable[[str], None]
    t0: float  # the process's start: set-up is counted from here
    window_t0: Optional[float] = None

    @property
    def setup_s(self) -> float:
        return self.window_t0 - self.t0


@dataclasses.dataclass
class Window:
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    trace: Optional[_trace.Trace] = None
    trace_calls: dict = dataclasses.field(default_factory=dict)
    trace_note: str = ""


def closed_loop(ctx: Context, request: Callable[[int], None], top: str,
                launched: tuple = ()) -> Window:
    """Call ``request(i)`` for i = 0, 1, ... until ``ctx.seconds`` have
    passed, the next request sent as the last one returns.  ``request``
    opens the ``top`` span around its call and synchronises inside it.

    The window runs from the first request's start to the last one's
    end, so every request in it is whole.  A request that raises is
    counted as failed.  In a traced run the requests from the second on,
    ``trace_requests`` of them, run under the profiler with the spans
    armed; a trace that is not whole (:func:`harness.trace.whole`) is
    dropped and the next requests are traced instead, up to
    ``TRACE_ATTEMPTS`` times."""
    torch = ctx.torch
    w = Window()
    per_trace = int(ctx.traffic.get("trace_requests", 1))
    prof, traced_from, attempts = None, None, 0
    ctx.window_t0 = time.perf_counter()
    i = 0
    while True:
        if (ctx.trace and w.trace is None and prof is None and i >= 1
                and attempts < TRACE_ATTEMPTS):
            attempts += 1
            ctx.spans.clear()
            ctx.spans.armed = True
            prof = _trace.profiler(torch)
            prof.start()
            traced_from = i
        t = time.perf_counter()
        try:
            request(i)
        except (RuntimeError, ValueError, torch.cuda.OutOfMemoryError) as e:
            w.failed += 1
            ctx.log(f"request {i} failed: {type(e).__name__}: {e}")
        else:
            w.latencies.append(time.perf_counter() - t)
        w.attempted += 1
        i += 1
        if prof is not None and i - traced_from == per_trace:
            prof.stop()
            ctx.spans.armed = False
            tr = _trace.reduce(prof, top)
            expected = {top: per_trace}
            expected.update({k: len(v) for k, v in ctx.spans.calls.items()})
            note = _trace.whole(tr, expected, (top,) + tuple(launched))
            if note is None:
                w.trace = tr
                w.trace_calls = {k: list(v)
                                 for k, v in ctx.spans.calls.items()}
            else:
                w.trace_note = f"attempt {attempts}: {note}"
                ctx.log(f"trace not whole, {w.trace_note}")
            prof = None
        traced = not ctx.trace or w.trace is not None or \
            attempts >= TRACE_ATTEMPTS
        if time.perf_counter() - ctx.window_t0 >= ctx.seconds and \
                prof is None and traced:
            break
    w.window_s = time.perf_counter() - ctx.window_t0
    if w.latencies:
        lat = sorted(w.latencies)
        slow = max(range(len(w.latencies)), key=w.latencies.__getitem__)
        ctx.log(f"latency s: min {lat[0]:.6f}, median {lat[len(lat) // 2]:.6f}"
                f", max {lat[-1]:.6f} (request {slow} of {len(lat)})")
    return w
