"""The program's own spans (``repro_torch.obs``: the solve's stages, the
Cholesky factorizations and triangular solves, the top-k sketch and
panel) in a trace of their own, which the metrics of the program's
stages read.

The window's trace holds the benchmark's spans only, taken with the
program's spans off, so the per-layer metrics that read it are what they
would be without this module.  Once the window has closed and its
answers have been judged, :func:`traced` takes a second, short trace of
the cell's request with the program's spans on: ring member 0 made
again from the run's seed, a fresh plan of the cell's request, the mix's
``warm_requests`` untraced, then ``trace_requests`` requests under the
profiler, each inside the benchmark's ``bench.solve`` span with its rows
re-signed before it, as in the window.  The program's spans are
``record_function`` ranges, on the device trace's clock: a device
operation belongs to a stage when the host call that launched it ran
inside the stage's span.  A trace missing a span the program recorded,
or a request with no device operation under it, is dropped and taken
again, up to ``TRACE_ATTEMPTS`` times.

The pass runs once a run, whichever reader asks first; its log lines give
the stage table and the breakdown with each device operation and idle
gap named by its innermost program span (``svd.eigh/...``).  A program
without ``repro_torch.obs`` (one older than its spans) has no stages:
:func:`traced` returns None at once, and every reader of a stage leaves
its metric out.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Dict, Optional

from harness import manifest as _manifest
from harness import trace as _trace
from harness.traffic import ring_scale, row_signs
from harness.window import TRACE_ATTEMPTS

_KEY = "program_stages"  # the attribute of the run's Context that caches it


def program_obs():
    """The program's span module ``repro_torch.obs``, or None where the
    program has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs


@dataclasses.dataclass
class Stages:
    """A trace with the program's spans: ``trace`` keeps them as spans
    beside the benchmark's ``bench.solve``; ``calls`` {span name: [the
    ``work`` the program recorded, one a span]}; ``program`` the
    program's span names; ``attempts`` the traces taken to get a whole
    one."""

    trace: _trace.Trace
    calls: Dict[str, list]
    program: tuple
    attempts: int = 1

    def _index(self) -> dict:
        """{span name: {tid: starts sorted}}, which a device operation's
        (tid, index) keys point into."""
        out = {}
        for name in self.program:
            per: Dict[int, list] = {}
            for tid, s, _ in sorted(self.trace.spans.get(name, ()),
                                    key=lambda x: x[1]):
                per.setdefault(tid, []).append(s)
            out[name] = per
        return out

    def stage(self, under: dict, index: Optional[dict] = None):
        """The innermost program span among ``under`` (a device
        operation's spans): the one that began last."""
        index = self._index() if index is None else index
        best, start = None, None
        for name in self.program:
            key = under.get(name)
            if key is not None:
                s = index[name][key[0]][key[1]]
                if start is None or s > start:
                    best, start = name, s
        return best

    def stage_at(self, t: int) -> Optional[str]:
        """The innermost program span running at ``t`` on the thread of
        the requests."""
        tr = self.trace
        tids = {tid for tid, _, _ in tr.spans.get(tr.top, ())}
        best, start = None, None
        for name in self.program:
            for tid, s, e in tr.spans.get(name, ()):
                if tid in tids and s <= t <= e and \
                        (start is None or s > start):
                    best, start = name, s
        return best

    def table(self) -> Dict[str, tuple]:
        """{program span: (spans, device s launched under them, device s
        of which it is the innermost program span)}, for the names the
        trace holds."""
        index = self._index()
        inner: Dict[str, int] = {}
        for s, e, _, under in self.trace.device:
            name = self.stage(under, index)
            if name is not None:
                inner[name] = inner.get(name, 0) + (e - s)
        tr = self.trace
        return {n: (tr.count(n), tr.device_s(n), inner.get(n, 0) * 1e-9)
                for n in self.program if tr.count(n)}

    def breakdown(self, top: int = 10) -> dict:
        """The window's breakdown (:meth:`harness.trace.Trace.breakdown`)
        with each name prefixed by its innermost program span: the span
        the operation was launched under, the span the host was in when
        the gap began."""
        tr, index = self.trace, self._index()
        a, b = tr.window
        by_name: Dict[str, int] = {}
        for s, e, name, under in tr.device:
            if a <= s < b:
                key = _staged(self.stage(under, index),
                              name[:_trace.NAME_CHARS])
                by_name[key] = by_name.get(key, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = tr.busy_intervals()
        edges = [a] + [x for iv in busy for x in iv] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": [[_staged(self.stage_at(s), tr.host_at(s)),
                               (e - s) * 1e-9] for s, e in gaps]}


def _staged(stage: Optional[str], name: str) -> str:
    """``name`` under the program span ``stage``."""
    if stage is None or stage == name:
        return name
    return f"{stage}/{name}"


def reduce(prof, top: str, program: tuple) -> _trace.Trace:
    """:func:`harness.trace.reduce` keeping the program's spans (their
    names exactly: no name the program or torch opens begins with one of
    them) beside the benchmark's, and dropping their copies on the
    device timeline with the benchmark's."""
    return _trace.reduce(prof, top, prefix=("bench.",) + tuple(program))


def traced(ctx, run) -> Optional[Stages]:
    """The run's trace of the program's stages, taken at the first call
    (:func:`take`) and kept on ``ctx``; None where the program has no
    spans or no trace came out whole."""
    if not hasattr(ctx, _KEY):
        obs = program_obs()
        setattr(ctx, _KEY, None if obs is None else take(ctx, run, obs))
    return getattr(ctx, _KEY)


def take(ctx, run, obs) -> Optional[Stages]:
    """Trace the cell's request with the program's spans on, after the
    window (the module's docstring); log the stage table and the staged
    breakdown."""
    torch, dev, ref = ctx.torch, ctx.device, ctx.reference
    entry = _manifest.load_module("entries", ctx.traffic["entry"])
    top = entry.TOP
    mat, traffic = ctx.config["matrix"], ctx.traffic
    n, kappa = int(mat["n"]), float(mat["kappa"])
    dtype = getattr(torch, mat["dtype"])
    kind = traffic["request"]
    a = ref.synthesize(n, kappa, _manifest.sub_seed(ctx.seed, "ring/0"),
                       ring_scale(0), device=dev, dtype=dtype)[0]
    draws = row_signs(torch, _manifest.sub_seed(ctx.seed, "stages"), n, dev)
    signs = torch.ones(n, device=dev)
    plan, call = entry._plan(ctx, kind, n, dtype)
    per = int(traffic.get("trace_requests", 1))
    # every request a device operation; off the card there is none
    launched = (top,) if dev.type == "cuda" else ()

    def request():
        nonlocal signs
        d = next(draws)
        a.mul_((d * signs)[:, None])
        signs = d
        with torch.profiler.record_function(top):
            call(a)
            entry._sync(torch, dev)

    t0 = time.perf_counter()
    for _ in range(int(traffic.get("warm_requests", 1))):
        request()
    out = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        prof = _trace.profiler(torch)
        obs.take()
        obs.enable()
        prof.start()
        try:
            for _ in range(per):
                request()
        finally:
            prof.stop()
            obs.disable()
        records = obs.take()
        tr = reduce(prof, top, obs.SPANS)
        expected = {top: per}
        expected.update(collections.Counter(name for name, _, _ in records))
        note = _trace.whole(tr, expected, launched)
        if note is None:
            calls: Dict[str, list] = {}
            for name, _, work in records:
                calls.setdefault(name, []).append(work)
            out = Stages(trace=tr, calls=calls, program=tuple(obs.SPANS),
                         attempts=attempt)
            break
        ctx.log(f"stages: trace not whole, attempt {attempt}: {note}")
    del plan, call, a
    entry._free_plans()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if out is None:
        return None
    _log(ctx, run, out, per, len(records), time.perf_counter() - t0)
    return out


def _log(ctx, run, st: Stages, per: int, spans: int, took: float) -> None:
    tr = st.trace
    top_s = tr.span_s(tr.top) / per
    lat = run["window"].latencies
    against = ""
    if lat:
        med = statistics.median(lat)
        against = (f" (the window's untraced median {med:.6f} s: "
                   f"{100.0 * (top_s / med - 1.0):+.2f}%)")
    ctx.log(f"stages: trace whole at attempt {st.attempts}, {took:.1f} s "
            f"with set-up: {per} {tr.top} spans of {top_s:.6f} s on "
            f"average{against}, {spans} program spans, idle "
            f"{100.0 * (1.0 - tr.busy_s / tr.window_s):.3f}%")
    ctx.log("stages a request (spans, device s under them, device s "
            "innermost): " + ", ".join(
                f"{n} {c / per:g} {d / per:.6f} {own / per:.6f}"
                for n, (c, d, own) in st.table().items()))
    b = st.breakdown()
    ctx.log("stages device_ops: " + "; ".join(
        f"{name} {t:.6f}" for name, t in b["device_ops"]))
    ctx.log("stages idle_gaps: " + "; ".join(
        f"{name} {t:.6f}" for name, t in b["idle_gaps"]))
