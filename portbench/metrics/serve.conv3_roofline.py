"""serve.conv3_roofline: the least time of the 3x3 int8 convs (count.py;
operations bound them) over the traced device time of the int8 conv
kernels, for the batches of the traced half of the window."""

import count


def read(ctx):
    if ctx.kind != 'serve' or ctx.trace is None:
        return None
    spent = ctx.trace.seconds_by_family().get('int8_conv', 0.0)
    if spent <= 0:
        return None
    bound = count.serve_bound(ctx.model, ctx.height, ctx.width, ctx.batch,
                              ctx.bf16)['int8_conv']['bound_s']
    return 100.0 * bound * ctx.traced / spent
