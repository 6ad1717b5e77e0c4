"""The SVD service end-to-end on the card: a heterogeneous request stream
— tall, wide, two dtypes, two accuracy modes — bucketed into a padded
plan pool and continuously micro-batched.

The PyTorch/CUDA port's counterpart of ``examples/svd_serve.py``: one
``SvdService`` on the device (``ServiceConfig.device``) runs the 8 slots
of every micro-batch, in place of a batch sharded one matrix per device
over 8 devices.  The same requests from the same draws.

  python examples/torch_svd_serve.py              (the card)
  python examples/torch_svd_serve.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.solver as S  # noqa: E402
from repro_torch.launch.svd_serve import synth_matrix  # noqa: E402
from repro_torch.serve import ServiceConfig, SvdService  # noqa: E402

SLOTS = 8  # the reference's device count: one slot per device there


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)
    device = S.resolve_device(args.device)
    print(f"device: {device}, {SLOTS} slots a micro-batch")

    svc = SvdService(ServiceConfig(batch_size=SLOTS, max_wait=0.002,
                                   device=str(device)))

    # warm + pin the expected buckets: after this, every request is a
    # plan-cache hit and the stream builds no plan
    shapes = [(96, 64), (40, 100), (120, 80)]
    keys = svc.warmup(shapes, modes=("fast", "standard"),
                      dtypes=("float64", "float32"))
    print(f"warmed {len(keys)} bucket plans "
          f"(cache: {S.cache_stats()['pinned']} pinned)")

    rng = np.random.default_rng(0)
    reqs, futs = [], []
    for i in range(3 * SLOTS):
        m, n = shapes[int(rng.integers(len(shapes)))]
        dtype = (torch.float64, torch.float32)[int(rng.integers(2))]
        mode = ("fast", "standard")[int(rng.integers(2))]
        # stay inside the "fast" mode's kappa-1e2 accuracy contract:
        # out-of-contract requests fail their health check and escalate
        # (correct, but then the stream builds retry plans and the
        # zero-retrace claim below would not hold)
        a = synth_matrix(m, n, kappa=1e2, seed=i, dtype=dtype,
                         device=device)
        reqs.append((a, mode))
        futs.append(svc.submit(a, mode))   # non-blocking
    svc.poll(force=True)                   # dispatch everything queued

    worst = {"float64": 0.0, "float32": 0.0}
    for (a, mode), fut in zip(reqs, futs):
        u, s, vh = fut.result()            # the only blocking edge
        a64 = a.to(torch.float64)
        rec = torch.linalg.norm(
            u.to(torch.float64) * s.to(torch.float64)[..., None, :]
            @ vh.to(torch.float64) - a64)
        key = str(a.dtype).rsplit(".", 1)[-1]
        worst[key] = max(worst[key], float(rec / torch.linalg.norm(a64)))
    st = svc.stats()
    print(f"served {st['solves']} solves in {st['batches']} batches "
          f"({SLOTS} slots each, on one device)")
    print(f"worst reconstruction error: {max(worst.values()):.2e} "
          f"(f64 {worst['float64']:.2e}, f32 {worst['float32']:.2e})")
    print(f"pad waste {st['pad_waste']:.0%}, slot fill "
          f"{st['slot_fill']:.0%}, plan-cache hit rate "
          f"{st['plan_cache_hit_rate']:.0%}, retraces {st['retraces']}")
    return {"solves": st["solves"], "batches": st["batches"],
            "worst_rec": worst, "pad_waste": st["pad_waste"],
            "slot_fill": st["slot_fill"],
            "hit_rate": st["plan_cache_hit_rate"],
            "retraces": st["retraces"]}


if __name__ == "__main__":
    main()
