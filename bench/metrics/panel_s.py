"""panel_s.<cell kind>: device seconds of a top-k request's panel
stage: the device time of everything launched inside the program's
``topk.panel`` spans (the (l, n) panel's solve and the lift U = Q·U_B)
of the stage trace (:mod:`harness.stages`), over its ``topk.request``
spans.  None where the program records no such span."""

from harness.stages import traced


def value(trace, run, ctx):
    st = traced(ctx, run)
    if st is None:
        return None
    requests = st.trace.count("topk.request")
    if not requests or not st.trace.count("topk.panel"):
        return None
    return st.trace.device_s("topk.panel") / requests
