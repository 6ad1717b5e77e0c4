"""cholesky_roofline.<cell kind>: the program's Cholesky factorizations'
share of their roofline: the sum over the ``linalg.cholesky`` spans
(``repro_torch.core.linalg.cholesky``) of the stage trace
(:mod:`harness.stages`) of each call's least time, the larger of
batch·n³/3 operations at the card's f32 peak and batch·8n² bytes (the
f32 matrix read, its factor written) at the HBM rate, over the device
time of everything launched inside those spans.  None where the program
records no such span."""

from harness.roofline import peaks
from harness.stages import traced


def value(trace, run, ctx):
    st = traced(ctx, run)
    if st is None:
        return None
    calls = st.calls.get("linalg.cholesky") or []
    dev_s = st.trace.device_s("linalg.cholesky")
    if not calls or dev_s <= 0:
        return None
    p = peaks(run["kind"])
    bound = sum(c["batch"] * max(c["n"] ** 3 / 3.0 / p["f32_flops"],
                                 8.0 * c["n"] ** 2 / p["hbm_bytes_per_s"])
                for c in calls)
    return 100.0 * bound / dev_s
