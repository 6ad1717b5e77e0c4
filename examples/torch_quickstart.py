"""Quickstart on the card: plan once, solve many — the
``repro_torch.solver`` plan/execute API, validated against LAPACK's SVD.

The PyTorch/CUDA port's counterpart of ``examples/quickstart.py``: the
same matrix from the same numpy draws, solved in f64 on the CUDA card
(``--device cpu`` runs it on the CPU).

  python examples/torch_quickstart.py              (the card)
  python examples/torch_quickstart.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.core as C  # noqa: E402
import repro_torch.solver as S  # noqa: E402


def test_matrix(n: int, kappa: float) -> np.ndarray:
    """The reference's matrix: Haar-ish U, V from seed 0 and a geometric
    spectrum from 1 to 1/kappa."""
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.standard_normal((n, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (u * np.geomspace(1, 1 / kappa, n)) @ v.T


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to solve on (default: the card)")
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args(argv)
    device = S.resolve_device(args.device)

    n, kappa = args.n, 1e8
    a_np = test_matrix(n, kappa)
    a = torch.from_numpy(a_np).to(device)
    print(f"matrix: {n}x{n}, kappa={kappa:.0e}, device={device}")

    # 1. plan: auto method via the registry cost model, r per paper
    #    Table 1, l0 from the conditioning hint, schedule precomputed.
    cfg = S.SvdConfig(method="auto", kappa=kappa,
                      l0_policy="estimate_at_plan")
    p = S.plan(cfg, a.shape, a.dtype, device=device)
    print(f"plan: {p}  schedule_iters={len(p.schedule or ())} "
          f"flops~{p.flops_estimate():.2e}")

    # 2. execute: the plan holds everything a solve needs; a repeat at
    #    this (shape, dtype, config, device) builds no second plan.
    u_p, s_p, vh_p = p.svd(a)
    t0 = S.trace_count()
    p.svd(a)
    if S.trace_count() != t0:
        raise RuntimeError("the second solve must not build a plan")
    s_ref = np.linalg.svd(a_np, compute_uv=False)
    s_np = s_p.cpu().numpy()
    out = {"method": p.method, "s": s_np,
           "residual": float(C.svd_residual(a, u_p, s_p, vh_p)),
           "orth_u": float(C.orthogonality(u_p)),
           "sigma_err": float(np.abs(s_np - s_ref).max())}
    print(f"{p.method}-SVD: residual={out['residual']:.2e}, "
          f"orthU={out['orth_u']:.2e}, "
          f"max |sigma - ref|={out['sigma_err']:.2e}")

    # 3. the paper's Zolo-PD explicitly, off a second plan, plus the
    #    polar factorization from the same plan object.
    zolo = S.plan(cfg.replace(method="zolo_static"), a.shape, a.dtype,
                  device=device)
    q, h, info = zolo.polar(a)
    out["zolo_iterations"] = int(info.iterations)
    out["zolo_orth"] = float(C.orthogonality(q))
    out["zolo_rec"] = float(torch.linalg.norm(q @ h - a)
                            / torch.linalg.norm(a))
    print(f"Zolo-PD: r={zolo.r}, iterations={out['zolo_iterations']}, "
          f"orth={out['zolo_orth']:.2e}, |QH-A|/|A|={out['zolo_rec']:.2e}")

    # 4. dynamic QDWH baseline through the drop-in wrapper (the wrapper
    #    rides the same plan path; the estimate is made at run time).
    _, _, info2 = C.polar_decompose(a, method="qdwh", want_h=False)
    out["qdwh_iterations"] = int(info2.iterations)
    print(f"QDWH-PD: iterations={out['qdwh_iterations']} "
          f"(Zolo saves {out['qdwh_iterations'] - out['zolo_iterations']})")
    return out


if __name__ == "__main__":
    main()
