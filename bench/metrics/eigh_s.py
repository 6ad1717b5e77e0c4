"""eigh_s.<cell kind>: device seconds of the eigensolve of H a solve:
the device time of everything launched inside the program's
``svd.eigh`` spans of the stage trace (:mod:`harness.stages`), over its
``svd.solve`` spans.  None where the program records no such span."""

from harness.stages import traced


def value(trace, run, ctx):
    st = traced(ctx, run)
    if st is None:
        return None
    solves = st.trace.count("svd.solve")
    if not solves or not st.trace.count("svd.eigh"):
        return None
    return st.trace.device_s("svd.eigh") / solves
