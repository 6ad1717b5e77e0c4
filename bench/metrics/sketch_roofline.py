"""sketch_roofline.<cell kind>: the top-k sketch's share of its
roofline: the sum over the ``topk.sketch`` spans
(``repro_torch.spectral.sketch.sketch_topk``'s range finder and B = QᵀA)
of the stage trace (:mod:`harness.stages`) of ``products`` matrix
products of an (m, n) matrix with an l-wide panel, each the larger of
2·m·n·l operations at the card's f32 peak and 4·(m·n + (m + n)·l) bytes
at the HBM rate, over the device time of everything launched inside
those spans, the CholeskyQR2s between the products included.  None where
the program records no such span."""

from harness.roofline import peaks
from harness.stages import traced


def value(trace, run, ctx):
    st = traced(ctx, run)
    if st is None:
        return None
    calls = st.calls.get("topk.sketch") or []
    dev_s = st.trace.device_s("topk.sketch")
    if not calls or dev_s <= 0:
        return None
    p = peaks(run["kind"])
    bound = 0.0
    for c in calls:
        m, n, l = c["m"], c["n"], c["l"]
        bound += c["products"] * max(
            2.0 * m * n * l / p["f32_flops"],
            4.0 * (m * n + (m + n) * l) / p["hbm_bytes_per_s"])
    return 100.0 * bound / dev_s
