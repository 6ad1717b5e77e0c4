"""host_syncs.<cell kind>: host syncs a request: the CUDA runtime calls
that block the host until the card has caught up
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, the synchronous ``cudaMemcpy``) that start
inside the program's span around one request — ``svd.solve`` for the
mix's ``request`` "dense", ``topk.request`` for "topk" — in the stage
trace (:mod:`harness.stages`), over its spans of that name.  The
benchmark's own synchronise after each request lies outside the span.
None where the program records no such span."""

import bisect

from harness.stages import traced

SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
REQUEST_SPAN = {"dense": "svd.solve", "topk": "topk.request"}


def value(trace, run, ctx):
    st = traced(ctx, run)
    if st is None:
        return None
    tr = st.trace
    spans = tr.spans.get(REQUEST_SPAN.get(ctx.traffic.get("request")))
    if not spans:
        return None
    starts = [s for s, _, _ in tr.host]
    syncs = 0
    for _, a, b in spans:
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
        syncs += sum(name in SYNCS for _, _, name in tr.host[lo:hi])
    return syncs / len(spans)
