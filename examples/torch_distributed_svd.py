"""Paper Algorithm 3 live on 8 gloo ranks, through the plan API: the r
subgroup contexts as a ("zolo", "sep") grid of ``torch.distributed``
ranks bound into an SvdPlan at plan time, with the DGSUM2D combine as an
all-reduce over each rank's "zolo" group.

The PyTorch/CUDA port's counterpart of ``examples/distributed_svd.py``:
8 gloo ranks in place of 8 host devices, each its own process; on the
card they share it.  Also runs the paper-faithful vs gram-shared flop
accounting.  The same matrices from the same numpy draws, in f64.

  python examples/torch_distributed_svd.py              (the card)
  python examples/torch_distributed_svd.py --device cpu
"""

import argparse
import datetime
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

WORLD = 8  # the reference's host-device count
# a collective that hangs fails after this many seconds in every rank
COLLECTIVE_TIMEOUT = 300


def _matrix(rng, m, n, kappa):
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return u @ np.diag(np.geomspace(1, 1 / kappa, n)) @ v.T


def run(rank, world, device, m, n):
    """The example's body on one rank (every rank calls it with the full
    matrix); rank 0 prints.  Returns the rank's record."""
    import repro_torch.core as C
    import repro_torch.solver as S
    from repro_torch.dist.grouped import (
        grouped_iteration_flops,
        zolo_group_mesh,
    )

    def say(*parts):
        if rank == 0:
            print(*parts, flush=True)

    rec = {"rank": rank, "world": world, "grouped": {}}
    say(f"ranks: {world} (gloo, {device.type})")
    rng = np.random.default_rng(5)
    kappa = 9.06e3  # linverse-class conditioning
    a_np = _matrix(rng, m, n, kappa)
    a = torch.from_numpy(a_np).to(device)
    s_ref = np.linalg.svd(a_np, compute_uv=False)

    for r in (2, 4):
        mesh = zolo_group_mesh(r, device=device)
        say(f"\nr={r}: mesh = {{'zolo': {mesh.r}, 'sep': {mesh.sep}}}  "
            f"(TOP context = {r} groups, SEP = {mesh.sep} ranks each)")
        # the mesh makes mode resolve to "grouped"; the Zolotarev
        # schedule is precomputed at plan time and the plan is cached
        # per (shape, dtype, config, device, mesh)
        cfg = S.SvdConfig(method="auto", kappa=kappa,
                          l0_policy="estimate_at_plan")
        p = S.plan(cfg, a.shape, a.dtype, mesh=mesh)
        say(f"  plan: method={p.method} mode={p.mode} r={p.r} "
            f"sep={p.sep} schedule_iters={len(p.schedule)}")
        q, h, info = p.polar(a)
        orth = float(C.orthogonality(q))
        rec_err = float(torch.linalg.norm(q @ h - a) / torch.linalg.norm(a))
        say(f"  orth={orth:.2e}  rec={rec_err:.2e}")
        # the full grouped SVD (paper Alg. 2 over Alg. 3)
        _, s_p, _ = p.svd(a)
        err = float(np.abs(s_p.cpu().numpy() - s_ref).max())
        say(f"  Zolo-SVD singular-value error vs LAPACK: {err:.2e}")
        # cost model: paper-faithful (per-group Gram) vs gram-shared,
        # and the per-rank effect of the intra-group sep distribution
        iters = len(p.schedule)
        faithful = grouped_iteration_flops(m, n, r, iters, False)
        shared = grouped_iteration_flops(m, n, r, iters, True)
        sep_aware = grouped_iteration_flops(m, n, r, iters, False,
                                            sep=p.sep)
        say(f"  flops: paper-faithful={faithful:.3e}  "
            f"gram-shared={shared:.3e}  saving={faithful / shared:.2f}x")
        say(f"  per-rank critical path (sep={p.sep}): "
            f"{sep_aware / r:.3e}  "
            f"(plan.flops_estimate={p.flops_estimate():.3e})")
        rec["grouped"][r] = {"method": p.method, "sep": p.sep,
                             "iterations": int(info.iterations),
                             "orth": orth, "rec": rec_err, "sigma_err": err,
                             "flops_saving": faithful / shared}

    # --- run-time conditioning: one plan for any kappa -----------------
    # l0_policy="runtime" + mesh= resolves to zolo_grouped_dynamic: the
    # sigma_min bound is estimated sep-collectively on the device and
    # feeds Zolotarev coefficients computed there, so the SAME plan
    # serves well- and ill-conditioned inputs and builds nothing new.
    mesh = zolo_group_mesh(2, device=device)
    p_dyn = S.plan(S.SvdConfig(l0_policy="runtime"), a.shape, a.dtype,
                   mesh=mesh)
    say(f"\nruntime-kappa plan: method={p_dyn.method} r={p_dyn.r} "
        f"sep={p_dyn.sep}")
    rec["runtime"] = {"method": p_dyn.method, "cases": {}}
    for kap in (1e2, 1e8):
        a2 = torch.from_numpy(_matrix(rng, m, n, kap)).to(device)
        t0 = S.trace_count()
        q, _, info = p_dyn.polar(a2, want_h=False)
        orth = float(C.orthogonality(q))
        plans = S.trace_count() - t0
        say(f"  kappa={kap:.0e}: orth={orth:.2e}  "
            f"iters={int(info.iterations)}  retraces={plans}")
        rec["runtime"]["cases"][kap] = {"orth": orth, "retraces": plans,
                                        "iterations": int(info.iterations)}
    return rec


def _rank(rank, world, init, dev_type, m, n, results):
    """One spawned rank: join the gloo world, run the body, put the
    record (or the traceback) on ``results``."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        if dev_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            results.put(run(rank, world, device, m, n))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default: the card, "
                         "shared by the ranks)")
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)

    from repro_torch.solver import resolve_device

    device = resolve_device(args.device)
    import torch.multiprocessing as mp

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    scratch = tempfile.mkdtemp(prefix="torch_distributed_svd_")
    init = "file://" + os.path.join(scratch, "init")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, WORLD, init, device.type,
                                            args.m, args.n, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    recs = {}
    try:
        while len(recs) < WORLD:
            try:
                rec = results.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died (exit codes "
                                       f"{[p.exitcode for p in procs]})")
                continue
            if "error" in rec:
                raise RuntimeError(f"rank {rec['rank']} failed:\n"
                                   f"{rec['error']}")
            recs[rec["rank"]] = rec
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(scratch, ignore_errors=True)
    return recs[0]


if __name__ == "__main__":
    main()
