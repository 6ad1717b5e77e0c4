"""mfu.svd: the solve's share of the card's float32 peak, counting the
operations of one SVD with U, S and V whatever computes it: Golub and
Van Loan's 4m²n + 8mn² + 9n³ (21n³ at m = n), over the time of the
traced solves (their ``bench.solve`` spans)."""

from harness.roofline import peaks


def svd_flops(m: int, n: int) -> float:
    return 4.0 * m * m * n + 8.0 * m * n * n + 9.0 * n ** 3


def value(trace, run, ctx):
    if ctx.traffic.get("request") != "dense":
        return None
    k, t = trace.count("bench.solve"), trace.span_s("bench.solve")
    if not k or t <= 0:
        return None
    n = int(ctx.config["matrix"]["n"])
    return 100.0 * k * svd_flops(n, n) / t / peaks(run["kind"])["f32_flops"]
