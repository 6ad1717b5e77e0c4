"""trsm_roofline.<cell kind>: the program's triangular solves' share of
their roofline: the sum over the ``linalg.trsm`` spans
(``repro_torch.core.linalg.solve_triangular``: an (n, n) triangle, k
right-hand columns, ``batch`` of them) of the stage trace
(:mod:`harness.stages`) of each call's least time, the larger of
batch·n²·k operations at the card's f32 peak and
batch·4·(n(n+1)/2 + 2nk) bytes (the f32 triangle and right-hand side
read, the solution written) at the HBM rate, over the device time of
everything launched inside those spans.  None where the program records
no such span."""

from harness.roofline import peaks
from harness.stages import traced


def value(trace, run, ctx):
    st = traced(ctx, run)
    if st is None:
        return None
    calls = st.calls.get("linalg.trsm") or []
    dev_s = st.trace.device_s("linalg.trsm")
    if not calls or dev_s <= 0:
        return None
    p = peaks(run["kind"])
    bound = 0.0
    for c in calls:
        n, k = c["n"], c["k"]
        bound += c["batch"] * max(
            float(n) * n * k / p["f32_flops"],
            4.0 * (n * (n + 1) / 2 + 2 * n * k) / p["hbm_bytes_per_s"])
    return 100.0 * bound / dev_s
