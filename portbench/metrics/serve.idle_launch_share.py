"""serve.idle_launch_share: the share of the traced half of the serving
window in which no kernel ran on the card while the host was inside the
program's `ursonet.serve.forward` span (`spans.py`): the card waiting on
the forward's launches. A part of serve.idle_share. None where the
program has no such span."""

import spans


def read(ctx):
    return spans.idle_share(ctx, 'serve', 'ursonet.serve.forward')
