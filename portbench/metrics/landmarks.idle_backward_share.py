"""landmarks.idle_backward_share: the share of the traced half of the
landmark model's training window in which no kernel ran on the card while
the host was inside the program's `ursonet.train.backward` span
(`spans.py`). A part of landmarks.idle_share. None where the program has
no such span."""

import spans


def read(ctx):
    return spans.idle_share(ctx, 'train_landmarks', 'ursonet.train.backward')
