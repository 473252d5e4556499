"""landmarks.idle_share: the share of the traced half of the landmark
model's training window in which no kernel ran on the card (copies and
fills count as idle)."""


def read(ctx):
    if ctx.kind != 'train_landmarks' or ctx.trace is None \
            or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.kernel_busy_s / ctx.trace.window_s)
