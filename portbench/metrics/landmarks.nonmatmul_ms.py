"""landmarks.nonmatmul_ms: device milliseconds a step, in the traced half
of the window, in every operation of the landmark model's step but the
matrix products: batch norm forward and backward, upsampling, sums and
ReLUs, copies and layout transposes, the warp and the targets."""


def read(ctx):
    if ctx.kind != 'train_landmarks' or ctx.trace is None or not ctx.traced:
        return None
    fams = ctx.trace.seconds_by_family()
    return 1e3 * sum(v for k, v in fams.items() if k != 'matmul') \
        / ctx.traced
