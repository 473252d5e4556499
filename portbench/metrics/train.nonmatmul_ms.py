"""train.nonmatmul_ms: device milliseconds a step, in the traced half of
the window, in every operation but the matrix products: frozen batch norm,
elementwise passes, copies and layout transposes, reductions, pooling, the
warp."""


def read(ctx):
    if ctx.kind != 'train' or ctx.trace is None or not ctx.traced:
        return None
    fams = ctx.trace.seconds_by_family()
    other = sum(v for k, v in fams.items() if k != 'matmul')
    return 1e3 * other / ctx.traced
