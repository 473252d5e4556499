"""train.mfu: three times the forward FLOPs of the model's convs and
denses (from the shapes, count.py; no recompute counted) times the images
of the steps in the untraced half of the window, over its seconds, as a
share of the card's 989 TFLOP/s in bf16."""

import count


def read(ctx):
    if ctx.kind != 'train' or not ctx.window_s:
        return None
    fwd = count.train_flops(ctx.model, ctx.height, ctx.width)['forward']
    return 100.0 * 3.0 * fwd * ctx.images / ctx.window_s \
        / count.PEAK_BF16_FLOPS
