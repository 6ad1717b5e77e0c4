"""The benchmark's spans, and the reduction of a profiler trace to the
numbers its per-layer metrics read.

The spans are the benchmark's own ``record_function`` scopes: one around
each request of the window (``bench.solve``), and, in a traced run, one
around each call of a function of the program that a metric reads
(``bench.gram`` around ``repro_torch.kernels.ops.gram``).  A wrapper
looks the function up on its module, so it sees every call the program
makes through that name, and synchronises nothing.

The trace is kept in memory and reduced there from the profiler's raw
events (no chrome trace is written): a device operation belongs to a
span when the host call that launched it ran inside the span, matched by
the profiler's correlation ids.  A trace whose spans are not whole (a
span missing, or a wrapped call with no device operation under it) is
refused, since the profiler drops events now and then.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional

NAME_CHARS = 120  # a device operation's name as the breakdown gives it


class Spans:
    """Wrappers of module functions that open a span around each call
    and, while armed, record what ``describe`` makes of its arguments."""

    def __init__(self, torch):
        self._torch = torch
        self._undo = []
        self.armed = False
        self.calls: Dict[str, list] = {}

    def wrap(self, module, attr: str, span: str,
             describe: Optional[Callable] = None) -> None:
        fn = getattr(module, attr)
        record = self._torch.profiler.record_function
        self.calls.setdefault(span, [])

        def wrapped(*args, **kwargs):
            if not self.armed:
                return fn(*args, **kwargs)
            self.calls[span].append(describe(*args, **kwargs)
                                    if describe else None)
            with record(span):
                return fn(*args, **kwargs)

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()

    def clear(self) -> None:
        for v in self.calls.values():
            v.clear()


def profiler(torch):
    """A profiler of host and device activity, without shapes, stacks
    or memory (they cost time and add nothing the metrics read)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=False,
                   profile_memory=False, with_stack=False)


@dataclasses.dataclass
class Trace:
    """The reduced trace of one traced part of the window.

    ``spans``: {name: [(tid, start_ns, end_ns)]}; ``device``: [(start_ns,
    end_ns, name, {span name: (tid, index) of the span it was launched
    under})]; ``host``: host events of the window's thread [(start_ns,
    end_ns, name)] sorted by start."""

    spans: Dict[str, list]
    device: List[tuple]
    host: List[tuple]
    top: str

    @property
    def window(self):
        top = self.spans.get(self.top, [])
        return min(s for _, s, _ in top), max(e for _, _, e in top)

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * 1e-9

    def busy_intervals(self):
        a, b = self.window
        out = []
        for s, e, _, _ in sorted(self.device):
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def count(self, span: str) -> int:
        return len(self.spans.get(span, ()))

    def span_s(self, span: str) -> float:
        return sum(e - s for _, s, e in self.spans.get(span, ())) * 1e-9

    def device_s(self, span: str) -> float:
        """Device time of the operations launched inside ``span``."""
        return sum(e - s for s, e, _, under in self.device
                   if span in under) * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, by
        name, and the longest idle gaps, named by the innermost host event
        running when each began."""
        a, b = self.window
        by_name: Dict[str, int] = {}
        for s, e, name, _ in self.device:
            if a <= s < b:
                key = name[:NAME_CHARS]
                by_name[key] = by_name.get(key, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [a] + [x for iv in busy for x in iv] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": [[self.host_at(s), (e - s) * 1e-9]
                              for s, e in gaps]}

    def host_at(self, t: int) -> str:
        """The innermost host event of the window's thread running at
        ``t`` (the one that began last among those that contain it)."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best = None
        for s, e, name in reversed(self.host[:i]):
            if e >= t:
                best = name
                break
        return best or "(no host event)"


def _enclosing(index, tid: int, t: int):
    """The key (tid, i) of the span in ``index`` ({tid: (starts, ends)})
    that contains ``t``, or None."""
    starts_ends = index.get(tid)
    if starts_ends is None:
        return None
    starts, ends = starts_ends
    i = bisect.bisect_right(starts, t) - 1
    return (tid, i) if i >= 0 and ends[i] >= t else None


def reduce(prof, top: str, prefix: str = "bench.") -> Trace:
    """Reduce ``prof`` (a stopped :func:`profiler`) to a :class:`Trace`:
    the spans whose names start with ``prefix``, each device operation
    with the spans it was launched under, and the host events of the
    thread that ran the ``top`` spans."""
    events = prof.profiler.kineto_results.events()
    spans: Dict[str, list] = {}
    host_all = []
    by_op, by_runtime = {}, {}  # correlation id -> (start_ns, tid)
    dev = []
    for e in events:
        name = e.name()
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if "CUDA" in str(e.device_type()):
            if name.startswith(prefix):
                continue  # a span's copy on the device's timeline
            dev.append((start, end, name, int(e.linked_correlation_id()),
                        int(e.correlation_id())))
            continue
        tid = int(e.start_thread_id())
        corr = int(e.correlation_id())
        if corr:
            # the runtime's launch calls carry the device operation's id;
            # host ops carry the id a device operation links to
            table = by_runtime if name.startswith("cu") else by_op
            table.setdefault(corr, (start, tid))
        if name.startswith(prefix):
            spans.setdefault(name, []).append((tid, start, end))
        host_all.append((start, end, name, tid))
    index = {}
    for name, ivs in spans.items():
        per = {}
        for tid, s, e in sorted(ivs, key=lambda x: x[1]):
            per.setdefault(tid, ([], []))
            per[tid][0].append(s)
            per[tid][1].append(e)
        index[name] = per
    device = []
    for s, e, name, link, corr in dev:
        launch = by_runtime.get(corr) or by_op.get(link)
        under = {}
        if launch is not None:
            for n, idx in index.items():
                key = _enclosing(idx, launch[1], launch[0])
                if key is not None:
                    under[n] = key
        device.append((s, e, name, under))
    tids = {tid for tid, _, _ in spans.get(top, ())}
    host = sorted((s, e, n) for s, e, n, tid in host_all if tid in tids)
    return Trace(spans=spans, device=device, host=host, top=top)


def whole(trace: Trace, expected: Dict[str, int],
          launched: tuple = ()) -> Optional[str]:
    """None if the trace holds every span the harness opened (``expected``
    {name: count}) and a device operation under every span of the names
    in ``launched``; else what is missing."""
    for name, n in expected.items():
        got = trace.count(name)
        if got != n:
            return f"{name}: {got} spans in the trace, {n} opened"
    for name in launched:
        covered = {under[name] for *_, under in trace.device
                   if name in under}
        if len(covered) < trace.count(name):
            return (f"{name}: device operations under {len(covered)} of "
                    f"{trace.count(name)} spans")
    return None
