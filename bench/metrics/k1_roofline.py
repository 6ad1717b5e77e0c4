"""k1_roofline.<cell kind>: K1's share of its roofline: the sum
over the traced calls of ``repro_torch.kernels.ops.gram`` of each call's
least time (``harness.roofline.gram_bound_s`` at the call's (m, n)),
over the device time of everything those calls launched."""

from harness.roofline import gram_bound_s


def value(trace, run, ctx):
    calls = run["trace_calls"].get("bench.gram") or []
    dev_s = trace.device_s("bench.gram")
    if not calls or dev_s <= 0:
        return None
    bound = sum(gram_bound_s(m, n, it, run["kind"]) for m, n, it in calls)
    return 100.0 * bound / dev_s
