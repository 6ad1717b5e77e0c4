#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse-cpu   # tiny CPU rehearsal, no kernels

Phases, each printed as it runs:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. build: both Hopper kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (in parallel), and their ``-Xptxas -v`` report.
3. parity at full width: K1 (fused shifted Gram) at 11,999^2 in f32 and
   bf16 with c = 0, below and above the clamp floor, plus a ragged
   1000 x 333; K2 (r-term combine) at 11,999^2, r in {1, 4}, f32 and
   bf16, xw in {0, 1} — each against its plain PyTorch version (f32:
   max error / max|result|; bf16 output: one bf16 ulp plus the f32
   sums' error bound, elementwise).
4. kernel times (CUDA events, warm), beside the plain version, one
   PyTorch library call computing the same function, and the bound.
5. main path: the paper's linverse matrix (n = 11,999, kappa = 9.06e3)
   synthesized on the card and solved through
   ``plan(SvdConfig(method="zolo_cuda", ...)).svd(a)``, with the kernel
   launch counts of each solve, the accuracy against the exact spectrum,
   the wall time and the peak device memory.
   Then a split of one solve (``plan.polar`` vs ``eigh``) and the
   first CholeskyQR2 pass's numerical margin (the f32 Gram's smallest
   eigenvalue against the clamped shift and the first-pass ridge).
6. the same plan on ``method="zolo_static"`` (plain torch ops): its time
   and its singular values against the kernel path's.

The line before the last is a JSON object with one record per kernel;
the last is ``{"ok": true, "device": {...}}``.  Any failed check raises
and the script exits non-zero without that line.  It also exits non-zero
when no CUDA device is present (unless rehearsing on the CPU) and when
run outside a checkout of the repository.  A full record is written to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N = 11_999          # the paper's linverse dimension (Table 3)
KAPPA = 9.06e3      # its 2-norm condition number
R = 4               # the paper's r for linverse
RAGGED = (1000, 333)
EXPECT_LAUNCHES = {"gram": 10, "grouped_combine": 2}  # per linverse solve
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores, bf16 on them, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
K1_TOL = 5e-5       # max|err| / max|G|: f32 sums over m = 12k products
K2_TOL_F32 = 1e-6   # max|err| / max|Y| in f32 (bf16: combine_bf16_ok)
ACCURACY_TOL = 1e-4  # f32 eps * sqrt(n) ~ 1.3e-5, times a small factor


def say(*parts):
    print(*parts, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg):
    if not ok:
        fail(msg)


class Clock:
    """CUDA events on the card, the host clock in a CPU rehearsal."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def ms(self, fn, reps, warm=1):
        for _ in range(warm):
            fn()
        self.sync()
        if self.device.type == "cuda":
            e0 = self.torch.cuda.Event(enable_timing=True)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            self.torch.cuda.synchronize()
            return e0.elapsed_time(e1) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def bf16_ulp(torch, want):
    """One bf16 ulp of each element of ``want``."""
    w = want.float().abs()
    _, e = torch.frexp(torch.where(w > 0, w, torch.ones_like(w)))
    return torch.where(w > 0, torch.ldexp(torch.ones_like(w), e - 8),
                       torch.full_like(w, 2.0 ** -133))


def combine_bf16_ok(torch, got, want, x, t, a, mhat, xw):
    """K2 with a bf16 output: |got - want| <= one bf16 ulp of want plus
    the forward error bound of the two f32 sums, (2r + 2) eps(f32)
    |mhat| (|xw x| + sum_j |a_j t_j|) — the kernel's fused multiply-adds
    and the plain version's separate products round differently, which
    only shows where the sum cancels.  Returns (ok, elements beyond one
    ulp)."""
    r = t.shape[0]
    mag = (abs(xw) * x.float().abs()
           + torch.einsum("j,jmn->mn", a.abs(), t.float().abs()))
    slack = (2 * r + 2) * torch.finfo(torch.float32).eps * \
        float(abs(mhat)) * mag
    diff = (got.float() - want.float()).abs()
    ulp = bf16_ulp(torch, want)
    return bool((diff <= ulp + slack).all()), int((diff > ulp).sum())


def phase_device(torch, device):
    say("== phase 1: device")
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type == "cuda":
        info["name"] = torch.cuda.get_device_name(0)
        info["count"] = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        info["nvidia_smi"] = smi[0]
        say(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    info["allow_tf32"] = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                          "cudnn": torch.backends.cudnn.allow_tf32}
    info["float32_matmul_precision"] = torch.get_float32_matmul_precision()
    say(json.dumps(info))
    return info


def phase_build():
    from repro_torch.kernels import build

    say("== phase 2: build")
    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        say(f"{name}: {os.path.relpath(path, HERE)}")
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "smem", "bytes stack")):
                say("  " + line.strip())
    say(f"build seconds: {secs:.1f}")
    return {"seconds": secs, "ptxas": dict(build.PTXAS_LOG)}


def phase_parity(torch, device, n, ragged):
    from repro_torch.kernels import ops, ref

    say("== phase 3: kernel parity at full width")
    gen = torch.Generator(device=device).manual_seed(1234)
    rows = []

    def k1_case(a, tag):
        g0 = ref.gram_ref(a)
        floor = 8.0 * torch.finfo(torch.float32).eps * \
            float(torch.diagonal(g0).amax())
        for cname, c in (("0", 0.0), ("below_floor", 0.25 * floor),
                         ("above_floor", 4.0 * floor)):
            got = ops.gram(a, c)
            want = ref.gram_ref(a, c)
            err = float((got - want).abs().amax())
            rel = err / float(want.abs().amax())
            rows.append({"kernel": "gram", "case": f"{tag} c={cname}",
                         "max_abs_err": err, "rel_err": rel})
            say(f"K1 {tag} c={cname}: max_abs_err {err:.3e} rel "
                f"{rel:.3e}")
            check(rel <= K1_TOL, f"K1 {tag} c={cname}: rel {rel:.3e}")
            check(bool(torch.equal(got, got.mT)), f"K1 {tag} not symmetric")
            if c:
                # the shift the kernel applied, averaged over the diagonal
                # (c_eff is only ~8 ulps of max diag G, below the parity
                # tolerance): max(c, floor), i.e. the clamp fired or not
                applied = float((torch.diagonal(got).double()
                                 - torch.diagonal(ops.gram(a)).double())
                                .mean())
                expect = max(c, floor)
                say(f"   applied shift {applied:.4e}, expected {expect:.4e}")
                check(abs(applied - expect) <= 0.05 * expect,
                      f"K1 {tag} c={cname}: shift {applied:.4e} applied, "
                      f"{expect:.4e} expected")
            del got, want

    a32 = torch.randn((n, n), generator=gen, dtype=torch.float32,
                      device=device)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        k1_case(a32.to(dt), f"{tag} {n}x{n}")
        small = torch.randn(ragged, generator=gen, device=device).to(dt)
        k1_case(small, f"{tag} {ragged[0]}x{ragged[1]}")

    x32 = a32
    t32 = torch.randn((R, n, n), generator=gen, dtype=torch.float32,
                      device=device)
    coef = torch.randn((R,), generator=gen, dtype=torch.float32,
                       device=device)
    mhat = torch.tensor(0.987, device=device)
    for r in (1, R):
        for xdt, tdt, tag in ((torch.float32, torch.float32, "f32"),
                              (torch.bfloat16, torch.bfloat16, "bf16"),
                              (torch.bfloat16, torch.float32, "bf16/f32")):
            x = x32.to(xdt)
            t = t32[:r].to(tdt)
            for xw in (0.0, 1.0):
                got = ops.grouped_combine(x, t, coef[:r], mhat, xw)
                want = ref.grouped_combine_ref(x, t, coef[:r], mhat, xw)
                err = float((got.float() - want.float()).abs().amax())
                case = f"{tag} r={r} xw={xw:g}"
                if xdt == torch.float32:
                    rel = err / float(want.abs().amax())
                    ok = rel <= K2_TOL_F32
                    say(f"K2 {case}: max_abs_err {err:.3e} rel {rel:.3e}")
                else:
                    rel = None
                    ok, beyond = combine_bf16_ok(torch, got, want, x, t,
                                                 coef[:r], mhat, xw)
                    say(f"K2 {case}: max_abs_err {err:.3e}, within one "
                        f"bf16 ulp + f32 sum bound: {ok} ({beyond} "
                        f"elements beyond one ulp)")
                rows.append({"kernel": "grouped_combine", "case": case,
                             "max_abs_err": err, "rel_err": rel})
                check(ok, f"K2 {case}")
                del got, want
            del x, t
    return rows, (a32, t32, coef, mhat)


def phase_times(torch, device, clock, tensors, n):
    from repro_torch.kernels import ops, ref

    say("== phase 4: kernel times")
    a32, t32, coef, mhat = tensors
    m = n
    reps = 5 if device.type == "cuda" else 2
    recs = {}

    k1 = {"ms": clock.ms(lambda: ops.gram(a32), reps),
          "plain_ms": clock.ms(lambda: ref.gram_ref(a32), reps),
          "library_ms": clock.ms(lambda: a32.mT @ a32, reps)}
    bf = a32.to(torch.bfloat16)
    k1_bf16_ms = clock.ms(lambda: ops.gram(bf), 3)
    del bf
    # G is symmetric: the function needs m n (n + 1) flops (its upper
    # triangle); bytes: A read once, G written once
    flops = float(m) * n * (n + 1)
    nbytes = 4.0 * (m * n + n * n)
    k1["bound_ms"] = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    k1["bound_by"] = "operations" if flops / PEAK_F32 > \
        nbytes / PEAK_BYTES else "bytes"
    k1["shape"] = f"A f32 ({m}, {n}), c = 0"
    k1["bf16_ms"] = k1_bf16_ms
    k1["bf16_bound_ms"] = max(flops / PEAK_BF16,
                              2.0 * m * n / PEAK_BYTES) * 1e3
    say(f"K1 f32 ({m}, {n}): kernel {k1['ms']:.3f} ms, plain "
        f"{k1['plain_ms']:.3f} ms, library (a.T @ a) "
        f"{k1['library_ms']:.3f} ms, bound {k1['bound_ms']:.3f} ms "
        f"({k1['bound_by']}); bf16 kernel {k1_bf16_ms:.3f} ms (bound "
        f"{k1['bf16_bound_ms']:.3f} ms)")
    recs["gram"] = k1

    x = a32
    out = {}
    for r in (1, R):
        t = t32[:r]
        a = coef[:r]
        rec = {"ms": clock.ms(lambda: ops.polar_update(x, t, a, mhat),
                              4 * reps, warm=2),
               "plain_ms": clock.ms(
                   lambda: ref.polar_update_ref(x, t, a, mhat), reps),
               "library_ms": clock.ms(
                   lambda: torch.einsum("j,jmn->mn", a, t), reps)}
        nbytes = 4.0 * (r + 2) * m * n
        flops = (2.0 * r + 2.0) * m * n
        rec["bound_ms"] = max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3
        rec["bound_by"] = "bytes" if nbytes / PEAK_BYTES > \
            flops / PEAK_F32 else "operations"
        rec["shape"] = f"X f32 ({m}, {n}), T ({r}, {m}, {n}), xw = 1"
        say(f"K2 f32 r={r}: kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, library (einsum) "
            f"{rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_by']})")
        out[r] = rec
    recs["grouped_combine"] = dict(out[R], r1=out[1])
    return recs


def run_solve(torch, clock, p, a, counters):
    for mod in counters:
        mod.launches = 0
    clock.sync()
    t0 = time.perf_counter()
    u, s, vh = p.svd(a)
    clock.sync()
    secs = time.perf_counter() - t0
    return u, s, vh, secs, {m.__name__.rsplit(".", 1)[-1]: m.launches
                            for m in counters}


def phase_main(torch, device, clock, n):
    import repro_torch.solver as S
    from repro_torch.configs import svd_paper
    from repro_torch.core.svd import orthogonality
    from repro_torch.kernels import gram, grouped_combine

    say("== phase 5: main path (linverse through zolo_cuda)")
    counters = (gram, grouped_combine)
    t0 = time.perf_counter()
    a, s_true = svd_paper.synthesize("linverse", n=n, dtype=torch.float32,
                                     device=device)
    clock.sync()
    say(f"synthesized linverse ({n}, {n}) kappa {KAPPA:g} in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = S.SvdConfig(method="zolo_cuda", kappa=KAPPA,
                      l0_policy="estimate_at_plan", r=R)
    p = S.plan(cfg, (n, n), torch.float32, device=device)
    say(repr(p))
    check(len(p.schedule) == 2, f"schedule of {len(p.schedule)} iterations")
    runs = []
    for label in ("warm", "timed"):
        if device.type == "cuda" and label == "timed":
            torch.cuda.reset_peak_memory_stats()
        u, s, vh, secs, launches = run_solve(torch, clock, p, a, counters)
        say(f"{label} solve: {secs:.3f} s, launches {launches}")
        if device.type == "cuda":
            for k, v in EXPECT_LAUNCHES.items():
                check(launches[k] == v, f"{k} launched {launches[k]} times "
                      f"in one solve, expected {v}")
        runs.append((secs, launches))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    s64 = s.double()
    smax = float(s_true[0])
    check(bool(torch.isfinite(u).all() and torch.isfinite(s).all()
               and torch.isfinite(vh).all()), "non-finite factors")
    check(u.shape == (n, n) and s.shape == (n,) and vh.shape == (n, n),
          "factor shapes")
    check(bool((s[:-1] >= s[1:]).all()), "singular values not descending")
    s_err = float((s64 - s_true).abs().amax()) / smax
    a64 = a.double()
    resid = float(torch.linalg.matrix_norm(
        a64 - (u.double() * s64) @ vh.double()) /
        torch.linalg.matrix_norm(a64))
    del a64
    orth_u = float(orthogonality(u.double()))
    orth_v = float(orthogonality(vh.double().mT))
    main = {"n": n, "kappa": KAPPA, "r": R, "iterations": len(p.schedule),
            "warm_s": runs[0][0], "timed_s": runs[1][0],
            "launches_per_solve": runs[1][1], "peak_bytes": peak,
            "s_err": s_err, "residual": resid, "orth_u": orth_u,
            "orth_vh": orth_v}
    say(f"max|s - s_true|/s_max {s_err:.3e}; ||A - U S Vh||_F/||A||_F "
        f"{resid:.3e}; orth(U) {orth_u:.3e}; orth(Vh) {orth_v:.3e}")
    say(f"wall {runs[1][0]:.3f} s; peak memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    for name, val in (("s error", s_err), ("residual", resid),
                      ("orth(U)", orth_u), ("orth(Vh)", orth_v)):
        check(val <= ACCURACY_TOL, f"{name} {val:.3e} > {ACCURACY_TOL:g}")

    main["stages"] = phase_stages(torch, clock, p, a)
    main["first_pass"] = phase_first_pass(torch, p, a)

    say("== phase 6: plain yardstick (zolo_static)")
    ps = S.plan(cfg.replace(method="zolo_static"), (n, n), torch.float32,
                device=device)
    _, s_plain, _, secs, launches = run_solve(torch, clock, ps, a, counters)
    check(all(v == 0 for v in launches.values()),
          f"the plain path launched kernels: {launches}")
    sdiff = float(((s_plain.double() - s64).abs() / smax).amax())
    say(f"zolo_static solve: {secs:.3f} s; max|s_static - s_cuda|/s_max "
        f"{sdiff:.3e}")
    check(sdiff <= ACCURACY_TOL, f"zolo_static vs zolo_cuda {sdiff:.3e}")
    main["plain_s"] = secs
    main["plain_s_diff"] = sdiff
    return main


def phase_stages(torch, clock, p, a):
    """Split one solve: prescale + Zolo-PD + form_h (``plan.polar``), then
    ``eigh`` of the 12k x 12k H; the rest of ``svd`` is U = Q V and the
    sort."""
    from repro_torch.core import eig

    clock.sync()
    t0 = time.perf_counter()
    _, h, _ = p.polar(a)
    clock.sync()
    t1 = time.perf_counter()
    eig.eigh(h)
    clock.sync()
    t2 = time.perf_counter()
    stages = {"polar_s": t1 - t0, "eigh_s": t2 - t1}
    say(f"stages: prescale + Zolo-PD + form_h {stages['polar_s']:.3f} s, "
        f"eigh {stages['eigh_s']:.3f} s")
    return stages


def phase_first_pass(torch, p, a):
    """The numerical margin of the first CholeskyQR2 pass: the f32 Gram's
    smallest eigenvalue against the clamped smallest shift c_eff and the
    first-pass ridge, and whether Z_1 = G + shift I factors in f32."""
    from repro_torch.core import zolo
    from repro_torch.kernels import ops

    x, _ = p._prescale(a)
    g = ops.gram(x)
    c0 = torch.tensor(p.schedule[0].c[0::2], dtype=torch.float32,
                      device=a.device)
    c_eff = zolo._clamp_shift(c0, g, torch.float32)
    lam_min = float(torch.linalg.eigvalsh(g.double())[0])
    n = g.shape[-1]
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    z = g[None] + c_eff[:, None, None] * eye  # Z_j as the engine builds them
    info_clamped = int(torch.linalg.cholesky_ex(z[0]).info)
    z = zolo._first_pass_ridge(z, c_eff, torch.float32)[0]
    ridge = float((torch.diagonal(z) - torch.diagonal(g)).double().mean())
    info_ridged = int(torch.linalg.cholesky_ex(z).info)
    rec = {"gram_lambda_min": lam_min, "c_eff": float(c_eff[0]),
           "ridge": ridge, "cholesky_info_clamped": info_clamped,
           "cholesky_info_ridged": info_ridged}
    say(f"first pass: lambda_min(G) {lam_min:.3e}, c_eff {rec['c_eff']:.3e}, "
        f"ridged shift {ridge:.3e}; f32 Cholesky info of G + c_eff I: "
        f"{info_clamped}, with the ridge: {info_ridged}")
    check(info_ridged == 0, "the ridged first-pass Z does not factor")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run every phase but the build on the CPU at a "
                         "tiny size (the wrappers then run their plain "
                         "versions); prints no ok line")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not args.rehearse_cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    device = torch.device("cpu") if args.rehearse_cpu else \
        torch.device("cuda", 0)
    n, ragged = (N, RAGGED) if device.type == "cuda" else (160, (50, 17))
    clock = Clock(torch, device)

    t_start = time.perf_counter()
    record = {"device": phase_device(torch, device)}
    if device.type == "cuda":
        record["build"] = phase_build()
    record["parity"], tensors = phase_parity(torch, device, n, ragged)
    times = phase_times(torch, device, clock, tensors, n)
    del tensors
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["times"] = times
    record["main"] = main_rec = phase_main(torch, device, clock, n)
    record["seconds"] = time.perf_counter() - t_start

    kernels = []
    sources = {"gram": ("src/repro_torch/kernels/csrc/gram.cu",
                        "src/repro/kernels/gram.py:41"),
               "grouped_combine": (
                   "src/repro_torch/kernels/csrc/grouped_combine.cu",
                   "src/repro/kernels/grouped_combine.py:36")}
    main_case = {"gram": "f32 %dx%d c=0" % (n, n),
                 "grouped_combine": "f32 r=%d xw=1" % R}
    for name, (src, replaces) in sources.items():
        t = times[name]
        err = next(row["max_abs_err"] for row in record["parity"]
                   if row["kernel"] == name and row["case"] == main_case[name])
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main_rec["launches_per_solve"][name],
                        "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    record["kernels"] = kernels
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    say(f"total seconds: {record['seconds']:.1f}")

    say(json.dumps({"kernels": kernels}))
    if device.type != "cuda":
        say(json.dumps({"rehearsal": True, "device": "cpu"}))
        return 0
    say(record["device"]["nvidia_smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
