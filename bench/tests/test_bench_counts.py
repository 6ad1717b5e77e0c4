"""The operation and byte counts of the per-layer metrics, and the
reduction of a trace to the numbers they read."""

from __future__ import annotations

import pathlib
import sys
import types

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import manifest as M  # noqa: E402
from harness import roofline, trace  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def test_svd_flops_at_linverse():
    mfu = M.load_module("metrics", "mfu.svd")
    n = 11999
    assert mfu.svd_flops(n, n) == 21 * n ** 3
    assert mfu.svd_flops(n, n) == pytest.approx(3.6279e13, rel=1e-4)


def test_k1_bound_at_linverse():
    # f32 at 11,999²: operation-bound, 25.79 ms
    assert roofline.gram_bound_s(11999, 11999, 4, H100) == pytest.approx(
        25.787e-3, rel=1e-4)
    # a thin f32 Gram is byte-bound
    m, n = 2048, 64
    assert roofline.gram_bound_s(m, n, 4, H100) == pytest.approx(
        (m * n * 4 + 4 * n * n) / 3.35e12)
    with pytest.raises(KeyError):
        roofline.peaks("cpu")


class _Ev:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, start, dur, cuda=False, tid=1, corr=0,
                 link=0):
        self._v = (name, start, dur, cuda, tid, corr, link)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def _two_solves():
    """Two solves of 100 ns each on the host; in each, one wrapped call
    launching one 30 ns kernel, and one 20 ns kernel launched outside the
    wrapped call; the span's own copy on the device timeline."""
    ev = []
    for i, t0 in enumerate((1000, 2000)):
        ev.append(_Ev("bench.solve", t0, 100))
        ev.append(_Ev("bench.solve", t0, 100, cuda=True))
        ev.append(_Ev("bench.gram", t0 + 10, 20))
        ev.append(_Ev("cudaLaunchKernel", t0 + 12, 2, corr=10 + i))
        ev.append(_Ev("gram_kernel", t0 + 20, 30, cuda=True, corr=10 + i))
        ev.append(_Ev("aten::mm", t0 + 40, 5, corr=500 + i))
        ev.append(_Ev("cudaLaunchKernel", t0 + 41, 2, corr=20 + i))
        ev.append(_Ev("mm_kernel", t0 + 60, 20, cuda=True, corr=20 + i,
                      link=500 + i))
    return ev


def test_trace_reduction():
    tr = trace.reduce(_prof(_two_solves()), "bench.solve")
    assert tr.count("bench.solve") == 2 and tr.count("bench.gram") == 2
    assert tr.window == (1000, 2100)
    assert tr.busy_s == pytest.approx(100e-9)
    assert tr.device_s("bench.gram") == pytest.approx(60e-9)
    assert tr.device_s("bench.solve") == pytest.approx(100e-9)
    assert tr.span_s("bench.solve") == pytest.approx(200e-9)
    assert trace.whole(tr, {"bench.solve": 2, "bench.gram": 2},
                       ("bench.solve", "bench.gram")) is None
    b = tr.breakdown()
    assert b["device_ops"] == [["gram_kernel", pytest.approx(60e-9)],
                               ["mm_kernel", pytest.approx(40e-9)]]
    # the longest gap: from the first solve's last kernel to the second's
    # first, which began while the host ran the first solve's span
    assert b["idle_gaps"][0] == ["bench.solve", pytest.approx(940e-9)]
    assert len(b["idle_gaps"]) == 5  # before, between and after kernels


def test_trace_not_whole():
    ev = [e for e in _two_solves()
          if not (e.name() == "gram_kernel" and e.start_ns() > 2000)]
    tr = trace.reduce(_prof(ev), "bench.solve")
    assert "bench.gram" in trace.whole(tr, {"bench.solve": 2},
                                       ("bench.gram",))
    assert "3 opened" in trace.whole(tr, {"bench.solve": 3})


def test_device_idle_and_k1_share_readers():
    tr = trace.reduce(_prof(_two_solves()), "bench.solve")
    run = {"kind": H100, "trace_calls": {"bench.gram": [(11999, 11999, 4)]}}
    ctx = types.SimpleNamespace(traffic={"request": "dense"},
                                config={"matrix": {"n": 11999}})
    idle = M.load_module("metrics", "device_idle_share.dense")
    assert idle.value(tr, run, ctx) == pytest.approx(100 * (1 - 100 / 1100))
    k1 = M.load_module("metrics", "k1_roofline.topk")
    assert k1.value(tr, run, ctx) == pytest.approx(
        100 * 25.787e-3 / 60e-9, rel=1e-4)
    run["trace_calls"] = {}
    assert k1.value(tr, run, ctx) is None
