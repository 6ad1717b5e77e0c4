"""Entry: SVD requests from one closed-loop caller over a ring of
matrices made in set-up.

The mix's ``request`` is ``"dense"`` — a full SVD through
``repro_torch.solver.plan(SvdConfig(...), (n, n), dtype).svd`` — or
``"topk"`` — the leading ``k`` triplets through
``repro_torch.spectral.plan_topk(TopKConfig(...), (n, n), dtype).topk``.
Before each request the rows of its ring member are re-signed in place
(``harness.traffic.row_signs``), so no two requests send the same
matrix.  Every answer of the window is kept (a top-k answer as a copy of
its k triplets, not as a view into the program's panel) and judged once
the window has closed, by the configuration's reference, against the
limits the configuration states for the request kind.
"""

from __future__ import annotations

import math

from harness.manifest import sub_seed
from harness.traffic import ring_order, ring_scale, row_signs

TOP = "bench.solve"


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gram_call(a, c=0.0):
    """What the K1 roofline needs of one call: (m, n, itemsize)."""
    return (int(a.shape[-2]), int(a.shape[-1]), int(a.element_size()))


def _plan(ctx, kind, n, dtype):
    import repro_torch.solver as S

    svd_cfg = S.SvdConfig(**ctx.config["svd"])
    if kind == "dense":
        p = S.plan(svd_cfg, (n, n), dtype, device=ctx.device)
        return p, p.svd
    if kind == "topk":
        import repro_torch.spectral as SP

        t = ctx.traffic
        tk = SP.TopKConfig(k=t["k"], strategy=t["strategy"], tol=t["tol"],
                           kappa=svd_cfg.kappa, svd=svd_cfg)
        p = SP.plan_topk(tk, (n, n), dtype, device=ctx.device)
        return p, p.topk
    raise ValueError(f"unknown request kind {kind!r}")


def _free_plans():
    import repro_torch.solver as S
    import repro_torch.spectral as SP

    S.clear_plan_cache()
    SP.clear_topk_cache()


def run(ctx):
    from harness.window import closed_loop
    from repro_torch.kernels import gram as k1
    from repro_torch.kernels import grouped_combine as k2
    from repro_torch.kernels import ops as kops

    torch, dev, ref = ctx.torch, ctx.device, ctx.reference
    mat, traffic = ctx.config["matrix"], ctx.traffic
    n, kappa = int(mat["n"]), float(mat["kappa"])
    dtype = getattr(torch, mat["dtype"])
    kind = traffic["request"]
    k = int(traffic["k"]) if kind == "topk" else 0
    ring = [ref.synthesize(n, kappa, sub_seed(ctx.seed, f"ring/{j}"),
                           ring_scale(j), device=dev, dtype=dtype, k=k)
            for j in range(int(traffic["ring"]))]
    signs = [torch.ones(n, device=dev) for _ in ring]
    draws = row_signs(torch, ctx.seed, n, dev)
    plan, call = _plan(ctx, kind, n, dtype)
    ctx.log(f"plan {plan!r}")
    if ctx.spans is not None:
        ctx.spans.wrap(kops, "gram", "bench.gram", _gram_call)

    def send(j):
        """Re-sign member j's rows to the next draw; the draw."""
        d = next(draws)
        ring[j][0].mul_((d * signs[j])[:, None])
        signs[j] = d
        return d

    lines = []
    for w in range(int(traffic.get("warm_requests", 1))):
        before = (k1.launches, k2.launches)
        send(w % len(ring))
        call(ring[w % len(ring)][0])
        _sync(torch, dev)
        lines.append(f"warm request {w}: K1 {k1.launches - before[0]} / "
                     f"K2 {k2.launches - before[1]} launches")

    order = ring_order(ctx.seed, len(ring))
    answers = []

    def request(i):
        j = next(order)
        d = send(j)
        with torch.profiler.record_function(TOP):
            out = call(ring[j][0])
            _sync(torch, dev)
        if kind == "topk":  # the triplets, not the panel they lie in
            out = tuple(t.clone() for t in out)
        answers.append((j, d, out))

    before = (k1.launches, k2.launches)
    w = closed_loop(ctx, request, TOP, launched=("bench.gram",))
    k1_n, k2_n = k1.launches - before[0], k2.launches - before[1]
    done = max(len(w.latencies), 1)
    lines.append(f"window: {w.attempted} requests, {w.failed} failed; K1 "
                 f"{k1_n} / K2 {k2_n} launches ({k1_n / done:g} / "
                 f"{k2_n / done:g} a request)")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None

    # the program's state goes before the reference runs
    if ctx.spans is not None:
        ctx.spans.restore()
    del plan, call
    _free_plans()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # back to the matrices as made: D D = I exactly
    for (a, *_), d in zip(ring, signs):
        a.mul_(d[:, None])
    numbers = {"dense": ref.dense_numbers, "topk": ref.topk_numbers}[kind]
    worst = {}
    for j, d, (u, s, vh) in answers:
        # the answer for D A is (D U, s, Vh): judge (U, s, Vh) against A;
        # a top-k answer also against the exact leading vectors
        member = ring[j] if kind == "topk" else ring[j][:2]
        for name, v in numbers(*member, u * d[:, None], s, vh).items():
            worst[name] = max(worst.get(name, 0.0), v)
    del answers
    limits = ctx.config["limits"][kind]
    checks = {name: [worst.get(name, math.inf), float(lim)]
              for name, lim in limits.items()}
    shown = {k: v for k, v in worst.items() if k not in limits}
    if shown:
        lines.append("not held to a limit: " + ", ".join(
            f"{k} {v:.6e}" for k, v in sorted(shown.items())))
    return {"window": w, "checks": checks, "peak_bytes": peak,
            "lines": lines}
