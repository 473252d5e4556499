"""landmarks.mfu: three times the forward FLOPs of the landmark model's
convs (from the shapes, count_hrnet.py) times the images of the steps in
the untraced half of the window (the whole window with `--trace 0`),
over its seconds, as a share of the card's 989 TFLOP/s in bf16."""

import count
import count_hrnet


def read(ctx):
    if ctx.kind != 'train_landmarks' or not ctx.window_s:
        return None
    fwd = count_hrnet.train_flops(ctx.height, ctx.width,
                                  ctx.landmarks)['forward']
    return 100.0 * 3.0 * fwd * ctx.images / ctx.window_s \
        / count.PEAK_BF16_FLOPS
