"""serve.idle_share: the share of the traced half of the serving window in
which no kernel ran on the card (copies and fills count as idle: the
host-to-device copy has a metric of its own, serve.h2d_share)."""


def read(ctx):
    if ctx.kind != 'serve' or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.kernel_busy_s / ctx.trace.window_s)
