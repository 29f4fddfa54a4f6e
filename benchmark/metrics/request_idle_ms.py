"""request_idle_ms: the device's idle milliseconds inside the union of the
window's request set-up spans (`magi/request/...`: the inputs, the
sampler's plans and workspace, the capture of its step variants, the
prefix warm-up), before the first step."""

from benchmark import spans


def read(r):
    if r.trace is None:
        return None
    found = spans.program_spans(r.trace, "magi/request/")
    if not found:
        return None
    return 1e3 * spans.idle_seconds(r.trace.busy(), [[(s.start, s.end) for s in found]])[0]
