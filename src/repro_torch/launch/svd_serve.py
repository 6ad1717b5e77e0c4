"""SVD-serving launcher: synthetic open-loop workload against
:class:`repro_torch.serve.SvdService`.

Port of ``repro/launch/svd_serve.py``.  Open-loop means arrivals come
from a Poisson clock, not from completion callbacks — the stream does
not slow down when the service falls behind, so measured latency
includes real queueing delay (the honest serving metric; a closed loop
would hide overload).  Shapes and accuracy modes are drawn per request
from the configured pools, so the stream is heterogeneous the way the
bucketed plan pool is designed for.

  PYTHONPATH=src python -m repro_torch.launch.svd_serve --requests 64 \\
      --rate 200 --batch 4 --shapes 96x64,120x80,40x100 --device cpu

The service runs on ``--device`` (default ``cuda``, the current card;
without one it raises).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve import ServiceConfig, SvdService
from repro_torch.solver import resolve_device


def synth_matrix(m: int, n: int, kappa: float = 1e3, seed: int = 0,
                 dtype=torch.float64, device=None):
    """Geometric-spectrum test matrix (exact kappa_2, Haar-ish U/V).

    The reference's matrix: the same numpy draws from ``seed``, the same
    QR factors and spectrum, computed in f64 on ``device`` (None: the
    CUDA card) and cast to ``dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = min(m, n)
    g_u = torch.from_numpy(rng.standard_normal((m, k))).to(dev)
    g_v = torch.from_numpy(rng.standard_normal((n, k))).to(dev)
    u, _ = torch.linalg.qr(g_u)
    v, _ = torch.linalg.qr(g_v)
    s = torch.from_numpy(np.geomspace(1.0, 1.0 / kappa, k)).to(dev)
    return ((u * s) @ v.mT).to(dtype)


def run_workload(service: SvdService,
                 shapes: Sequence[Tuple[int, int]],
                 modes: Sequence[str] = ("standard",),
                 requests: int = 64,
                 rate: float = 200.0,
                 kappa: float = 1e3,
                 dtype=torch.float64,
                 seed: int = 0,
                 warm: bool = True) -> Dict[str, float]:
    """Drive one open-loop run; returns the serving record.

    Matrices are synthesized on the service's device before the clock
    starts, arrival times are a Poisson process at ``rate``/s, and the
    submission loop is the service's cooperative cadence: submit everything
    whose arrival time has passed, ``poll()``, sleep to the next arrival.
    Latency per request is submit-to-ready as stamped by the service's
    non-blocking completion sweep.
    """
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(requests):
        m, n = shapes[int(rng.integers(len(shapes)))]
        mode = modes[int(rng.integers(len(modes)))]
        reqs.append((synth_matrix(m, n, kappa, seed=i, dtype=dtype,
                                  device=service.device), mode))
    if warm:
        service.warmup(shapes, modes=modes, dtypes=(dtype,))
    arrivals = np.cumsum(rng.exponential(1.0 / rate, requests))

    futs: List = []
    i = 0
    t0 = time.perf_counter()
    while i < len(reqs):
        now = time.perf_counter() - t0
        while i < len(reqs) and arrivals[i] <= now:
            a, mode = reqs[i]
            futs.append(service.submit(a, mode))
            i += 1
        service.poll()
        if i < len(reqs):
            ahead = arrivals[i] - (time.perf_counter() - t0)
            if ahead > 0:
                time.sleep(min(ahead, 1e-3))
    service.flush()
    wall = time.perf_counter() - t0

    lats = np.asarray([f.latency for f in futs], float)
    ok = sum(1 for f in futs if f.exception() is None)
    stats = service.stats()
    return {
        "requests": requests,
        "rate_req_s": rate,
        "wall_s": wall,
        "solves_per_s": requests / wall,
        "p50_ms": float(np.percentile(lats, 50) * 1e3),
        "p99_ms": float(np.percentile(lats, 99) * 1e3),
        "pad_waste": stats["pad_waste"],
        "slot_fill": stats["slot_fill"],
        "plan_cache_hit_rate": stats["plan_cache_hit_rate"],
        "retraces": stats["retraces"],
        "batches": stats["batches"],
        # resilience counters: a fault-free run reports zeros and
        # ok == requests; a fault-injected run shows the recovery paths
        # the stream exercised
        "ok": ok,
        "verify": service.config.verify,
        "retries": stats["retries"],
        "health_failures": stats["health_failures"],
        "quarantined": stats["quarantined"],
        "deadline_expired": stats["deadline_expired"],
        "dispatch_errors": stats["dispatch_errors"],
    }


def _parse_shapes(text: str) -> List[Tuple[int, int]]:
    shapes = []
    for part in text.split(","):
        m, _, n = part.strip().partition("x")
        shapes.append((int(m), int(n)))
    return shapes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="open-loop arrival rate, requests/s")
    ap.add_argument("--batch", type=int, default=4,
                    help="micro-batch slot count per bucket")
    ap.add_argument("--max-wait", type=float, default=0.005,
                    help="partial-batch head-of-line age bound, s")
    ap.add_argument("--shapes", default="96x64,120x80,40x100",
                    help="comma-separated MxN request shape pool")
    ap.add_argument("--modes", default="standard",
                    help="comma-separated accuracy-mode pool")
    ap.add_argument("--kappa", type=float, default=1e3)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the service solves: cuda (the current "
                         "card; raises without one) or cpu")
    args = ap.parse_args(argv)

    service = SvdService(ServiceConfig(batch_size=args.batch,
                                       max_wait=args.max_wait,
                                       device=args.device))
    rec = run_workload(service, _parse_shapes(args.shapes),
                       modes=tuple(args.modes.split(",")),
                       requests=args.requests, rate=args.rate,
                       kappa=args.kappa, dtype=getattr(torch, args.dtype),
                       seed=args.seed)
    print(f"[svd_serve] {rec['requests']} requests at "
          f"{rec['rate_req_s']:.0f}/s open-loop -> "
          f"{rec['solves_per_s']:.1f} solves/s, "
          f"p50 {rec['p50_ms']:.1f} ms, p99 {rec['p99_ms']:.1f} ms")
    print(f"[svd_serve] pad waste {rec['pad_waste']:.0%}, slot fill "
          f"{rec['slot_fill']:.0%}, plan-cache hit rate "
          f"{rec['plan_cache_hit_rate']:.0%}, retraces {rec['retraces']}")


if __name__ == "__main__":
    main()
