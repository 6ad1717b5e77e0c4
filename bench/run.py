#!/usr/bin/env python3
"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell,
one run, one process.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for.  Set-up (kernels built or loaded from ``build/kernels/``,
inputs and weights made on the card from the seed, plans, warm-up) is
timed as ``setup_s``; then the cell's entry drives the program for
``--seconds``; then every answer of the window is judged against the
configuration's plain reference.  With ``--trace 1`` a short steady
part of the window runs under the profiler and the run reports the
per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, in a traced run
``breakdown``, and last ``checks``: each number compared, with its
limit.  The checks are also the last lines of standard error.  The run
exits non-zero and prints no result without the card(s), outside a
checkout that holds the program, or if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import device as _device  # noqa: E402
from harness import manifest as _manifest  # noqa: E402


def _say(*parts):
    print("bench:", *parts, flush=True)


def _err(*parts):
    print("bench:", *parts, file=sys.stderr, flush=True)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device=None, config=None, traffic=None, t0=None) -> dict:
    """Run one cell once and return the result line's object (its
    ``checks`` last).  ``device``, ``config`` and ``traffic`` stand in for
    the card and the cell's files (the tests run a cell on the CPU at a
    small size this way); the program is imported from ``src/``."""
    import torch

    from harness.trace import Spans
    from harness.window import Context

    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    manifest = _manifest.load_manifest()
    cell = _manifest.by_name(manifest["workloads"], cell_name, "workload")
    config = config or _manifest.load_json("configs", cell["config"])
    traffic = traffic or _manifest.load_json("traffic", cell["traffic"])
    entry = _manifest.load_module("entries", traffic["entry"])
    reference = _manifest.load_module("reference", cell["config"])
    dev = torch.device(device or "cuda:0")
    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_card else dev.type
    # the configurations state float32 with TF32 off (PyTorch's default);
    # the references need it off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(torch=torch, device=dev, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), config=config,
                  traffic=traffic, reference=reference,
                  spans=Spans(torch) if trace else None, log=_say,
                  t0=T0 if t0 is None else t0)
    out = entry.run(ctx)
    w = out["window"]
    run = {"setup_s": ctx.setup_s, "window": w, "kind": kind,
           "trace_calls": w.trace_calls}
    for line in out["lines"]:
        _say(line)
    _say(f"window {w.window_s:.3f} s, {w.attempted} attempted, {w.failed} "
         f"failed, {len(w.latencies)} completed; set-up {ctx.setup_s:.3f} s")

    metrics = {}
    if trace:
        if w.trace is None:
            raise RuntimeError(f"no whole trace of the window "
                               f"({w.trace_note or 'none taken'})")
        # a run off the card reports no device metric
        for m in _manifest.per_layer_for(manifest, cell_name) * on_card:
            v = _manifest.load_module("metrics", m["name"]).value(
                w.trace, run, ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in _manifest.end_to_end_for(manifest, cell_name):
            v = _manifest.load_module("end_to_end", m["name"]).value(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    checks = {name: {"value": _number(v), "limit": lim}
              for name, (v, lim) in out["checks"].items()}
    correct = (w.failed == 0 and len(w.latencies) > 0 and
               all(v <= lim for v, lim in out["checks"].values()))
    dev_rec = {"platform": "gpu" if on_card else dev.type, "kind": kind,
               "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": correct, "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": dev_rec}
    if trace:
        dev_rec["busy_s"] = w.trace.busy_s
        dev_rec["window_s"] = w.trace.window_s
        result["breakdown"] = w.trace.breakdown()
    result["checks"] = checks
    return result


def _number(v: float):
    """A JSON number, or the name of a value JSON has none for."""
    return v if math.isfinite(v) else repr(v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        _err(f"no program here: {ROOT / 'src' / 'repro_torch'} is missing")
        return 2
    manifest = _manifest.load_manifest()
    try:
        cell = _manifest.by_name(manifest["workloads"], args.workload,
                                 "workload")
    except KeyError as e:
        _err(str(e))
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        _err(f"needs {cell['chips']} CUDA card(s); "
             f"available: {torch.cuda.is_available()}, "
             f"count: {torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(1)  # host work is one thread; spare cores idle
    _say(f"device {torch.cuda.get_device_name(0)} x{cell['chips']} "
         f"({_device.power_limit()}); torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}; cell {args.workload}, seed {args.seed}, "
         f"{args.seconds:g} s, trace {args.trace}")
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    _say(f"peak memory {result['device']['memory_peak_bytes']} bytes")
    foreign = _device.foreign_modules()
    if foreign:
        _err(f"modules that must not be loaded: {foreign}")
        return 3
    for name, c in result["checks"].items():
        _err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
