"""train.conv_roofline: the conv and dense FLOPs of the steps in the traced
half of the window (forward, weight and input gradients, from the shapes:
count.py) at the card's 989 TFLOP/s in bf16 (operations bound them), over
the traced device time of the cuDNN and cuBLAS matrix-product kernels (the
trace's 'matmul' family)."""

import count


def read(ctx):
    if ctx.kind != 'train' or ctx.trace is None:
        return None
    spent = ctx.trace.seconds_by_family().get('matmul', 0.0)
    if spent <= 0:
        return None
    flops = count.train_flops(ctx.model, ctx.height, ctx.width)['matmul']
    images = ctx.traced * ctx.batch
    return 100.0 * flops * images / count.PEAK_BF16_FLOPS / spent
