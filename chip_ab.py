"""Times two checkouts of this repository against each other on one card.

    python3 chip_ab.py --a PARENT_ROOT [--b .] [--order abba]
                       [--out chiprun_out/chip_ab.json]

Each letter of ``--order`` starts one worker process on that checkout (A:
``--a``, B: ``--b``), one after another, so the default "abba" gives each
side two runs, one before and one after the other side's, and a drift of
the host or the card over the call shows as a difference between the two
runs of one side.  A worker imports ``repro_torch`` and ``chip_smoke.py``
from its own checkout only (its kernels build into that checkout's
``build/``) and measures, with TF32 off:

* K1 as the solver calls it (``core/zolo_cuda.py::cuda_zolo_ops().gram``,
  c = 0) on an f32 A at ZoloMuon's shapes, 12,288 x 4,096, 21b's rank
  blocks and 11,999^2, row-major and as a column-major view (the
  CholeskyQR2 second pass's Q1 and Q2): CUDA-event ms a call, and the
  device ms a call from ``torch.profiler``;
* K2 (``kernels/ops.py::polar_update``, r = 2, xw = 1) at the same shapes
  but 11,999^2, the same two ways;
* the main solve of chip_smoke.py's phase 5 (linverse, n = 11,999,
  through ``zolo_cuda``) by that checkout's own ``phase_main``: the
  timed solve's seconds, after a warm one;
* the training steps of chip_smoke.py's phase 19 (qwen3-8b, 2 layers) and
  20c / 20d (mamba2-130m, moonshot-v1-16b-a3b, trained), through that
  checkout's own ``phase_train`` and ``train_lm_case`` with its own step
  counts and checks (3, 2 and 1 timed steps after a warm one): seconds a
  step, ``orthogonalize`` and forward + backward seconds, K1/K2 launches;
* where the checkout's K1 splits over m (``kernels/gram.py`` has
  ``gram_slice_rows``), K1's kernel alone at every slice count S = 1..8
  on 64-wide tiles at ZoloMuon's shapes and 2,048 x 2,944: what
  ``gram_split`` is held to; and a column-major A read in place at S = 1
  beside the wrapper's call (which copies it row-major where no column
  is float4-aligned): what ``gram_f32_operand`` is held to.

The workers' output goes to ``chiprun_out/chip_ab/``; the summary (each
number per run, in the order run) is printed and written to ``--out``.
Needs one CUDA card: without one it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
K1_SHAPES = ((2048, 1408), (2048, 2048), (2048, 64), (3352, 768),
             (1536, 768), (4096, 1024), (12_288, 4096), (6144, 4096),
             (3072, 4096), (11_999, 11_999))
# the sweep behind gram_split: ZoloMuon's six shapes, and a G whose S = 2
# branch holds by a small margin
SWEEP_SHAPES = K1_SHAPES[:6] + ((2048, 2944),)


def event_ms(torch, fn, reps):
    """CUDA-event ms a call over ``reps`` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(torch, fn, reps):
    """Device ms a call from ``torch.profiler`` over ``reps`` calls after
    a warm-up step, or None where the trace holds no whole number of
    operations a call (the profiler can miss events)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    active = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: active.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    total, count = 0.0, 0
    for e in (active[0] if active else ()):
        if getattr(getattr(e, "device_type", None), "name", "") != "CUDA" \
                or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total", None)
        total += getattr(e, "self_cuda_time_total", 0.0) if us is None \
            else us
        count += e.count
    if count == 0 or count % reps:
        return None
    return total / reps / 1e3


def reps_for(m, n):
    return 5 if m * n * n >= 1e11 else 10 if m * n * n >= 1e10 else 40


def kernel_times(torch, device):
    """K1 and K2 at K1_SHAPES, row-major and column-major, as the solver
    calls them."""
    from repro_torch.core.zolo_cuda import cuda_zolo_ops
    from repro_torch.kernels import ops

    bundle = cuda_zolo_ops()
    gen = torch.Generator(device=device).manual_seed(22)
    out = {}
    for m, n in K1_SHAPES:
        reps = reps_for(m, n)
        a = torch.randn((m, n), generator=gen, device=device)
        rec = {}
        for lay, x in (("row", a), ("col", a.mT.contiguous().mT)):
            rec[f"k1_{lay}_ms"] = event_ms(torch, lambda: bundle.gram(x),
                                           reps)
            rec[f"k1_{lay}_device_ms"] = device_ms(
                torch, lambda: bundle.gram(x), reps)
            del x
        if m != n:
            t = torch.randn((2, m, n), generator=gen, device=device)
            coef = torch.randn((2,), generator=gen, device=device)
            mhat = torch.tensor(0.987, device=device)
            rec["k2_ms"] = event_ms(
                torch, lambda: ops.polar_update(a, t, coef, mhat), reps)
            rec["k2_device_ms"] = device_ms(
                torch, lambda: ops.polar_update(a, t, coef, mhat), reps)
            del t
        del a
        out[f"{m}x{n}"] = rec
        print(f"{m}x{n}: {rec}", flush=True)
    torch.cuda.empty_cache()
    return out


def split_sweep(torch, device):
    """K1's kernel alone at S = 1..8 on 64-wide tiles (row-major A, c =
    0), beside the S that ``gram_split`` gives: {shape: {S: ms}}."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import gram as kgram

    lib = kbuild.library("gram")
    sms = kgram.device_sms(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(23)
    out = {}
    for m, n in SWEEP_SHAPES:
        a = torch.randn((m, n), generator=gen, device=device)
        g = torch.empty((n, n), device=device)
        rec = {"rule": kgram.gram_split(m, n, sms)}
        for s in range(1, kgram.GRAM_MAX_SLICES + 1):
            rows = kgram.gram_slice_rows(m, s)
            cut = -(-m // rows)  # the slices whole chunks give
            if cut != s:
                continue

            def launch():
                kbuild.check(lib.zolo_gram_f32_split(
                    a.data_ptr(), 0, a.stride(0), g.data_ptr(), m, n, 64,
                    s, rows, None, stream), "gram sweep")

            rec[str(s)] = event_ms(torch, launch, 40)
        out[f"{m}x{n}"] = rec
        print(f"sweep {m}x{n}: {rec}", flush=True)
    return out


def column_reads(torch, device):
    """K1's kernel alone on a column-major A at S = 1 (tile 128) read in
    place, beside the wrapper's call on the same view, at 11,999^2 (no
    float4 column: the wrapper copies it row-major) and 12,288 x 4,096
    (float4 columns: the wrapper reads it in place): {shape: ms}."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import gram as kgram
    from repro_torch.kernels import ops

    lib = kbuild.library("gram")
    stream = torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(24)
    out = {}
    for m, n in ((11_999, 11_999), (12_288, 4096)):
        x = torch.randn((m, n), generator=gen, device=device).mT \
            .contiguous().mT
        g = torch.empty((n, n), device=device)
        rows = kgram.gram_slice_rows(m, 1)

        def launch():
            kbuild.check(lib.zolo_gram_f32_split(
                x.data_ptr(), 1, x.stride(1), g.data_ptr(), m, n, 128, 1,
                rows, None, stream), "gram column read")

        reps = reps_for(m, n)
        out[f"{m}x{n}"] = {"in_place_ms": event_ms(torch, launch, reps),
                           "wrapper_ms": event_ms(
                               torch, lambda: ops.gram(x), reps)}
        print(f"column-major {m}x{n}: {out[f'{m}x{n}']}", flush=True)
        del x, g
    torch.cuda.empty_cache()
    return out


def steps(torch, device, cs):
    """Phase 19's and 20c/20d's training steps through the checkout's own
    chip_smoke functions."""
    import dataclasses

    from repro_torch import configs as CFG

    clock = cs.Clock(torch, device)
    out = {}
    cfg = dataclasses.replace(CFG.get_config(cs.TRAIN_ARCH),
                              num_layers=cs.TRAIN_LAYERS)
    rec = cs.phase_train(torch, device, clock, {
        "cfg": cfg, "batch": cs.TRAIN_BATCH, "seq": cs.TRAIN_SEQ,
        "steps": cs.TRAIN_STEPS})
    out["19"] = rec
    counters = cs.kernel_modules()
    for label in ("20c", "20d"):
        case = cs.SERVE_LM[label]
        cfg = dataclasses.replace(CFG.get_config(case["arch"]),
                                  num_layers=case["layers"])
        out[label] = cs.train_lm_case(torch, device, clock, counters, cfg,
                                      case["train"], label)
    keep = ("step_s", "orthogonalize_s", "fwd_bwd_s", "update_s")
    return {k: {f: r.get(f) for f in keep} | {
        "steps_s": [t["seconds"] for t in r["steps"][1:]],
        "launches": r["steps"][-1]["launches"]} for k, r in out.items()}


def worker(root, out_path):
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch

    import chip_smoke as cs
    import repro_torch

    for mod in (cs, repro_torch):  # this checkout's, not the other's
        assert os.path.abspath(mod.__file__).startswith(
            os.path.abspath(root) + os.sep), mod.__file__
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.kernels import gram as kgram

    t0 = time.perf_counter()
    rec = {"root": root, "kernels": kernel_times(torch, device)}
    if hasattr(kgram, "gram_slice_rows"):
        rec["sweep"] = split_sweep(torch, device)
        rec["column_reads"] = column_reads(torch, device)
    main = cs.phase_main(torch, device, cs.Clock(torch, device), cs.N)[0]
    rec["solve"] = {k: main.get(k) for k in ("warm_s", "timed_s")}
    torch.cuda.empty_cache()
    rec["steps"] = steps(torch, device, cs)
    rec["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--a", help="the checkout timed as A (the parent)")
    p.add_argument("--b", default=HERE, help="the checkout timed as B")
    p.add_argument("--order", default="abba")
    p.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                 "chip_ab.json"))
    p.add_argument("--worker", nargs=2, metavar=("ROOT", "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(*args.worker)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.a:
        print("chip_ab: needs one CUDA card and --a", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    logs = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                        "chip_ab")
    os.makedirs(logs, exist_ok=True)
    roots = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    runs, ok = [], True
    for i, side in enumerate(args.order):
        out = os.path.join(logs, f"{i}_{side}.json")
        with open(os.path.join(logs, f"{i}_{side}.txt"), "w") as log:
            t0 = time.perf_counter()
            code = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 roots[side], out], stdout=log, stderr=subprocess.STDOUT,
                cwd=roots[side], timeout=1500).returncode
        print(f"run {i} ({side.upper()}, {roots[side]}): exit {code}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok &= code == 0
        runs.append(dict(json.load(open(out)), side=side) if code == 0
                     else {"side": side, "exit": code})
    summary = {"device": smi, "order": args.order, "roots": roots,
               "runs": runs}
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print("phase 5 solve s:", [r.get("solve", {}).get("timed_s")
                               for r in runs])
    for key in ("19", "20c", "20d"):
        print(key, "step s:", [r.get("steps", {}).get(key, {}).get("step_s")
                               for r in runs])
    for shape in (f"{m}x{n}" for m, n in K1_SHAPES):
        print(shape, [(r["side"], r.get("kernels", {}).get(shape))
                      for r in runs])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
