"""serve.mfu: the int8 operations of the model's int8 convs and denses
(from the shapes, count.py) times the images served in the untraced half
of the window, over its seconds, as a share of the card's 1979 TOP/s."""

import count


def read(ctx):
    if ctx.kind != 'serve' or not ctx.window_s:
        return None
    fams = count.serve_bound(ctx.model, ctx.height, ctx.width, ctx.batch,
                             ctx.bf16)
    ops = sum(f['ops'] for f in fams.values()) * ctx.batches
    return 100.0 * ops / ctx.window_s / count.PEAK_INT8_OPS
