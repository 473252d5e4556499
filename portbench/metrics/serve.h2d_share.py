"""serve.h2d_share: the share of the traced half of the serving window in
which a host-to-device copy ran on the card (the served batches shipped
from host memory); 0 where the window shipped none."""


def _h2d(name: str) -> bool:
    return name.startswith('Memcpy HtoD')


def read(ctx):
    if ctx.kind != 'serve' or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.trace.busy_of(_h2d) / ctx.trace.window_s
