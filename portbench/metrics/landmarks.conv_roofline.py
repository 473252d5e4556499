"""landmarks.conv_roofline: the conv FLOPs of the landmark model's steps in
the traced half of the window (forward, weight and input gradients, from
the shapes: count_hrnet.py) at the card's 989 TFLOP/s in bf16, over the
traced device time of the cuDNN and cuBLAS matrix-product kernels (the
trace's 'matmul' family)."""

import count
import count_hrnet


def read(ctx):
    if ctx.kind != 'train_landmarks' or ctx.trace is None:
        return None
    spent = ctx.trace.seconds_by_family().get('matmul', 0.0)
    if spent <= 0 or not ctx.traced:
        return None
    flops = count_hrnet.train_flops(ctx.height, ctx.width,
                                    ctx.landmarks)['matmul']
    return 100.0 * flops * ctx.traced * ctx.batch / count.PEAK_BF16_FLOPS \
        / spent
