"""The program's own spans in the stage trace (``harness.stages``): kept
beside the benchmark's, their copies on the device timeline dropped, the
breakdown named by the innermost of them, the readers of the metrics
that read them, and the stage trace itself taken on the CPU at a small
size."""

from __future__ import annotations

import pathlib
import sys
import types

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import control  # noqa: E402
from harness import manifest as M  # noqa: E402
from harness import roofline, stages, trace  # noqa: E402
from harness.window import Context, Window  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
PROGRAM = ("svd.solve", "svd.polar", "svd.eigh", "svd.lift",
           "linalg.cholesky", "linalg.trsm", "topk.request", "topk.sketch",
           "topk.panel")


class _Ev:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, start, end, cuda=False, corr=0, tid=1):
        self._v = (name, start, end - start, cuda, tid, corr)

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
        return 0


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def _kernel(ev, name, launch_at, start, end, corr):
    ev.append(_Ev("cudaLaunchKernel", launch_at, launch_at + 2, corr=corr))
    ev.append(_Ev(name, start, end, cuda=True, corr=corr))


def _span(ev, name, start, end, program):
    """A span on the host and its copy on the device timeline (kineto's
    ``gpu_user_annotation``), unless it is the program's and the
    program has no spans."""
    if name in PROGRAM and not program:
        return
    ev.append(_Ev(name, start, end))
    ev.append(_Ev(name, start + 5, end + 60, cuda=True))


def _dense(program=True):
    """One dense request: a Cholesky (200 ns), a triangular solve (400), a
    Gram through the wrapped call (100) in the polar stage; two eigh
    kernels (400, 200) with a host sync between them; a lift GEMM (250)
    that ends while the harness's own synchronise, outside the solve,
    waits for it."""
    ev = []
    _span(ev, "bench.solve", 1000, 3000, program)
    _span(ev, "svd.solve", 1010, 2900, program)
    _span(ev, "svd.polar", 1020, 1500, program)
    _span(ev, "linalg.cholesky", 1030, 1100, program)
    _kernel(ev, "potrf", 1040, 1040, 1240, 1)
    _span(ev, "linalg.trsm", 1110, 1200, program)
    _kernel(ev, "trsm", 1120, 1250, 1650, 2)
    _span(ev, "bench.gram", 1210, 1260, program)
    _kernel(ev, "gram", 1220, 1660, 1760, 3)
    _span(ev, "svd.eigh", 1500, 2500, program)
    _kernel(ev, "syevd", 1510, 1800, 2200, 4)
    ev.append(_Ev("cudaMemcpyAsync", 1990, 2000))
    ev.append(_Ev("cudaStreamSynchronize", 2000, 2250))
    _kernel(ev, "syevd", 2300, 2400, 2600, 5)
    _span(ev, "svd.lift", 2600, 2800, program)
    _kernel(ev, "sgemm", 2610, 2700, 2950, 6)
    ev.append(_Ev("cudaDeviceSynchronize", 2905, 2995))
    return ev



DENSE_CALLS = {"linalg.cholesky": [{"batch": 4, "n": 11999}],
               "linalg.trsm": [{"batch": 4, "n": 11999, "k": 11999}]}


def _staged(ev, calls=None):
    return stages.Stages(trace=stages.reduce(_prof(ev), "bench.solve",
                                             PROGRAM),
                         calls=calls or {}, program=PROGRAM)


def _read(name, st, request):
    """A reader's value where the run's stage trace is ``st`` (None: the
    program has no spans)."""
    ctx = types.SimpleNamespace(traffic={"request": request},
                                config={"matrix": {"n": 11999}},
                                program_stages=st)
    run = {"kind": H100, "trace_calls": {}}
    return M.load_module("metrics", name).value(None, run, ctx)


def test_program_spans_leave_the_trace_s_numbers_as_they_were():
    with_spans = stages.reduce(_prof(_dense()), "bench.solve", PROGRAM)
    without = trace.reduce(_prof(_dense(program=False)), "bench.solve")
    assert with_spans.count("svd.solve") == 1
    assert without.count("svd.solve") == 0
    # the copies on the device timeline are no device operations
    assert len(with_spans.device) == len(without.device) == 6
    for tr in (with_spans, without):
        assert tr.busy_s == pytest.approx(1550e-9)
        assert tr.device_s("bench.gram") == pytest.approx(100e-9)
        assert tr.count("bench.solve") == 1
        assert tr.span_s("bench.solve") == pytest.approx(2000e-9)
    run = {"kind": H100, "trace_calls": {"bench.gram": [(11999, 11999, 4)]}}
    ctx = types.SimpleNamespace(traffic={"request": "dense"},
                                config={"matrix": {"n": 11999}})
    for name in ("device_idle_share.dense", "k1_roofline.dense", "mfu.svd"):
        read = M.load_module("metrics", name).value
        assert read(with_spans, run, ctx) == pytest.approx(
            read(without, run, ctx))


def test_breakdown_names_the_innermost_program_span():
    b = _staged(_dense()).breakdown()
    ops = dict((n, t) for n, t in b["device_ops"])
    assert ops == {"svd.eigh/syevd": pytest.approx(600e-9),
                   "linalg.trsm/trsm": pytest.approx(400e-9),
                   "linalg.cholesky/potrf": pytest.approx(200e-9),
                   "svd.lift/sgemm": pytest.approx(250e-9),
                   # the wrapped call is the benchmark's, not a stage
                   "svd.polar/gram": pytest.approx(100e-9)}
    gaps = dict((n, t) for n, t in b["idle_gaps"])
    assert gaps["svd.eigh/cudaStreamSynchronize"] == pytest.approx(200e-9)
    # the window opens with the harness's span, before the program's
    assert gaps["bench.solve"] == pytest.approx(40e-9)
    # after the last: the harness's synchronise, in no program span
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(50e-9)
    # without the program's spans, the breakdown is the window's own
    plain = trace.reduce(_prof(_dense(program=False)), "bench.solve")
    assert _staged(_dense(program=False)).breakdown() == plain.breakdown()


def test_stage_table():
    st = {n: (c, pytest.approx(d), pytest.approx(i))
          for n, (c, d, i) in _staged(_dense()).table().items()}
    assert st == {"svd.solve": (1, 1550e-9, 0.0),
                  "svd.polar": (1, 700e-9, 100e-9),
                  "linalg.cholesky": (1, 200e-9, 200e-9),
                  "linalg.trsm": (1, 400e-9, 400e-9),
                  "svd.eigh": (1, 600e-9, 600e-9),
                  "svd.lift": (1, 250e-9, 250e-9)}
    assert _staged(_dense(program=False)).table() == {}


def test_whole_refuses_a_missing_program_span():
    ev = [e for e in _dense()
          if not (e.name() == "linalg.trsm" and "CPU" in e.device_type())]
    tr = stages.reduce(_prof(ev), "bench.solve", PROGRAM)
    expected = {"bench.solve": 1, "bench.gram": 1, "svd.solve": 1,
                "svd.polar": 1, "linalg.cholesky": 1, "linalg.trsm": 1,
                "svd.eigh": 1, "svd.lift": 1}
    assert trace.whole(tr, expected) == \
        "linalg.trsm: 0 spans in the trace, 1 opened"
    whole = stages.reduce(_prof(_dense()), "bench.solve", PROGRAM)
    assert trace.whole(whole, expected, ("bench.solve",)) is None


def test_dense_readers():
    st = _staged(_dense(), DENSE_CALLS)
    f32 = roofline.peaks(H100)["f32_flops"]
    n = 11999
    assert _read("cholesky_roofline.dense", st, "dense") == \
        pytest.approx(100 * 4 * n ** 3 / 3 / f32 / 200e-9)
    assert _read("trsm_roofline.dense", st, "dense") == \
        pytest.approx(100 * 4 * n ** 3 / f32 / 400e-9)
    assert _read("eigh_s.dense", st, "dense") == pytest.approx(600e-9)
    # the eigensolve's sync counts, the harness's after the solve does not
    assert _read("host_syncs.dense", st, "dense") == 1


def test_roofline_readers_take_the_byte_bound_of_a_thin_call():
    st = _staged(_dense(), {"linalg.trsm": [{"batch": 1, "n": 4,
                                             "k": 10 ** 6}]})
    p = roofline.peaks(H100)
    assert _read("trsm_roofline.dense", st, "dense") == \
        pytest.approx(100 * 4 * (10 + 8e6) / p["hbm_bytes_per_s"] / 400e-9)


def _topk(program=True):
    """One top-k request: a sketch of two products (300 ns) and a
    CholeskyQR2 between them (100), a panel solve (150) with one host
    sync."""
    ev = []
    _span(ev, "bench.solve", 1000, 2000, program)
    _span(ev, "topk.request", 1005, 1900, program)
    _span(ev, "topk.sketch", 1010, 1400, program)
    _kernel(ev, "sgemm", 1020, 1030, 1180, 1)
    _span(ev, "linalg.cholesky", 1100, 1150, program)
    _kernel(ev, "potrf", 1110, 1180, 1280, 2)
    _kernel(ev, "sgemm", 1300, 1300, 1450, 3)
    _span(ev, "topk.panel", 1400, 1850, program)
    _span(ev, "svd.eigh", 1410, 1600, program)
    _kernel(ev, "syevd", 1420, 1460, 1560, 4)
    ev.append(_Ev("cudaStreamSynchronize", 1500, 1560))
    _kernel(ev, "sgemm", 1700, 1700, 1750, 5)
    ev.append(_Ev("cudaDeviceSynchronize", 1905, 1990))
    return ev


def test_topk_readers():
    st = _staged(_topk(), {"topk.sketch": [{"m": 11999, "n": 11999,
                                            "l": 877, "products": 16}]})
    f32 = roofline.peaks(H100)["f32_flops"]
    assert _read("sketch_roofline.topk", st, "topk") == \
        pytest.approx(100 * 16 * 2 * 11999 ** 2 * 877 / f32 / 400e-9)
    assert _read("panel_s.topk", st, "topk") == pytest.approx(150e-9)
    assert _read("host_syncs.topk", st, "topk") == 1
    # a dense request's reader finds no svd.solve here
    assert _read("host_syncs.dense", st, "dense") is None


NEW = ("cholesky_roofline.dense", "trsm_roofline.dense", "eigh_s.dense",
       "host_syncs.dense", "sketch_roofline.topk", "panel_s.topk",
       "host_syncs.topk")


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_in_a_program_without_spans(name):
    """The parent's program: no stage trace (``traced`` gives None), or
    one without the program's spans; every new reader leaves its metric
    out."""
    request = name.split(".")[1]
    make = _dense if request == "dense" else _topk
    assert _read(name, None, request) is None
    assert _read(name, _staged(make(program=False)), request) is None


def test_the_manifest_lists_the_new_metrics():
    man = M.load_manifest()
    for name in NEW:
        m = M.by_name(man["per_layer"], name, "metric")
        assert m["source"] == "program_span"
        assert m["workloads"] == [{"dense": "linverse-dense",
                                   "topk": "linverse-topk128"}[
                                       name.split(".")[1]]]


def test_program_obs_is_the_program_s_span_module():
    obs = stages.program_obs()
    assert obs is not None and "svd.solve" in obs.SPANS


def _small_ctx(cell, lines):
    cell_, config, traffic = control.cell_files(cell, small=True)
    return Context(torch=torch, device=torch.device("cpu"),
                   seed=2 ** 31 + 7, seconds=0.0, trace=True,
                   config=config, traffic=traffic,
                   reference=M.load_module("reference", cell_["config"]),
                   spans=None, log=lines.append, t0=0.0)


def test_a_program_without_spans_is_not_traced(monkeypatch):
    """The parent's program: nothing is made, planned or run."""
    monkeypatch.setattr(stages, "program_obs", lambda: None)
    monkeypatch.setattr(stages, "take", lambda *a: pytest.fail("traced"))
    ctx = _small_ctx("linverse-dense", [])
    assert stages.traced(ctx, {"window": Window()}) is None


@pytest.mark.parametrize("cell,tree", [
    ("linverse-dense", {"bench.solve": 1, "svd.solve": 1,
                        "svd.prescale": 1, "svd.polar": 1,
                        "svd.form_h": 1, "svd.eigh": 1, "svd.lift": 1,
                        "linalg.cholesky": 3, "linalg.trsm": 6}),
    ("linverse-topk128", {"bench.solve": 8, "topk.request": 8,
                          "topk.sketch": 8, "topk.panel": 8,
                          "svd.polar": 8, "svd.eigh": 8})])
def test_stage_trace_on_the_cpu(cell, tree):
    """The stage trace of a small cell: the mix's traced requests with
    the program's spans, its records as the readers' calls, spans off
    after it, taken once a run."""
    torch.set_num_threads(2)
    lines = []
    ctx = _small_ctx(cell, lines)
    run = {"window": Window(latencies=[1.0]), "kind": "cpu"}
    st = stages.traced(ctx, run)
    assert st is not None and st.attempts == 1
    for name, n in tree.items():
        assert st.trace.count(name) == n, name
    assert "svd.solve" not in st.calls or cell == "linverse-dense"
    assert st.calls["linalg.cholesky"][0]["n"] > 0
    assert not stages.program_obs()._on
    assert stages.program_obs().take() == []
    assert stages.traced(ctx, run) is st
    assert any(line.startswith("stages a request") for line in lines)
