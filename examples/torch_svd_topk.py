"""Partial-spectrum SVD end-to-end on the card: top-k as a first-class
workload.

The PyTorch/CUDA port's counterpart of ``examples/svd_topk.py``, the
same matrices from the same numpy draws, in f64.  Three views of the
same subsystem:

1. ``plan_topk`` directly — the cost model picks the randomized-sketch
   path for k << n and falls back to dense for k ~ n; both plans are
   cached by (config, shape, dtype, device).
2. The adaptive wrapper — a-posteriori residual check with automatic
   escalation to the dense plan when the sketch cannot certify the
   requested tolerance.
3. The serving lane — ``mode="topk:<k>"`` requests batch in their own
   buckets of the service's plan pool.

  python examples/torch_svd_topk.py              (the card)
  python examples/torch_svd_topk.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.spectral as SP  # noqa: E402
from repro_torch.serve import ServiceConfig, SvdService  # noqa: E402
from repro_torch.solver import resolve_device  # noqa: E402


def synth(m, n, kappa, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    k = min(m, n)
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((n, k)))
    s = np.geomspace(1.0, 1.0 / kappa, k)
    return torch.from_numpy((u * s) @ v.T).to(device=device,
                                               dtype=torch.float64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: the card)")
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--k", type=int, default=16)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    m, n, k = args.m, args.n, args.k
    a = synth(m, n, kappa=1e6, seed=0, device=device)
    out = {}

    # 1. plan once, solve many: auto picks the sketch for k << n
    plan = SP.plan_topk(SP.TopKConfig(k=k, kappa=1e6), (m, n),
                        torch.float64, device=device)
    u, s, vh = plan.topk(a)
    ref = np.linalg.svd(a.cpu().numpy(), compute_uv=False)[:k]
    out["strategy"] = plan.strategy
    out["rel_err"] = float(np.abs(s.cpu().numpy() - ref).max() / ref[0])
    print(f"plan: strategy={plan.strategy} l={plan.l} "
          f"q_iters={plan.q_iters}")
    print(f"top-{k} values vs dense: max err {out['rel_err']:.2e}")
    print(f"factors: u{tuple(u.shape)} s{tuple(s.shape)} "
          f"vh{tuple(vh.shape)}")

    # ... and k ~ n hands the work to the dense path
    near_full = SP.plan_topk(SP.TopKConfig(k=n - 8, kappa=1e6), (m, n),
                             torch.float64, device=device)
    out["near_full_strategy"] = near_full.strategy
    print(f"k={n - 8} (~n): strategy={near_full.strategy}")

    # 2. adaptive: residual-certified, escalates only when needed
    u, s, vh, info = plan.topk_adaptive(a)
    out["adaptive"] = {"residual": float(info["residual"]),
                       "escalated": bool(info["escalated"])}
    print(f"adaptive: residual={out['adaptive']['residual']:.2e} "
          f"escalated={out['adaptive']['escalated']}")

    # 3. the serving lane: topk:<k> buckets in the plan pool
    svc = SvdService(ServiceConfig(batch_size=2, max_wait=0.0,
                                   device=str(device)))
    svc.warmup([(m, n)], modes=(f"topk:{k}",))
    futs = [svc.submit(synth(m, n, 1e6, seed=i, device=device),
                       mode=f"topk:{k}") for i in range(4)]
    svc.poll(force=True)
    for fut in futs:
        uk, sk, vhk = fut.result()
        if uk.shape != (m, k) or vhk.shape != (k, n):
            raise RuntimeError(f"topk:{k} returned u{tuple(uk.shape)} "
                               f"vh{tuple(vhk.shape)}")
    st = svc.stats()
    out.update(solves=st["solves"], batches=st["batches"],
               retraces=st["retraces"])
    print(f"served {st['solves']} topk solves in {st['batches']} "
          f"batches, retraces {st['retraces']}")
    return out


if __name__ == "__main__":
    main()
