"""serve.launch_ms: the host milliseconds a traced batch spends inside the
program's `ursonet.serve.forward` span (`spans.py`): the host issuing
the int8 forward, from its first launch to the return of the head
tensors, in the traced half of the window (the profiler's host overhead
included). A host-to-device copy inside the forward that synchronises
with the card makes the host wait there too. None where the program has
no such span."""

import spans


def read(ctx):
    if ctx.kind != 'serve' or ctx.trace is None or not ctx.traced:
        return None
    fwd = spans.span_intervals(ctx.trace, 'ursonet.serve.forward')
    if not fwd:
        return None
    return 1e3 * sum(e - s for s, e in fwd) / ctx.traced
