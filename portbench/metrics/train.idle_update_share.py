"""train.idle_update_share: the share of the traced half of the training
window in which no kernel ran on the card while the host was inside the
program's `ursonet.train.update` span (`spans.py`). A part of
train.idle_share. None where the program has no such span."""

import spans


def read(ctx):
    return spans.idle_share(ctx, 'train', 'ursonet.train.update')
