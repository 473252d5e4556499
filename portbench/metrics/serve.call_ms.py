"""serve.call_ms: the mean host time of a `predict_molded` call in the
untraced half of the window, from the harness's own span around each call
(hand-off to return, before the heads are copied to the host)."""


def read(ctx):
    if ctx.kind != 'serve' or not ctx.call_s:
        return None
    return 1e3 * sum(ctx.call_s) / len(ctx.call_s)
