"""landmarks.launches_per_step: the kernels the card ran in the traced half
of the landmark model's training window (copies and fills left out) over
its steps."""


def read(ctx):
    if ctx.kind != 'train_landmarks' or ctx.trace is None or not ctx.traced:
        return None
    kernels = sum(1 for name, _, _ in ctx.trace.ops
                  if not name.startswith(('Memcpy', 'Memset')))
    return kernels / ctx.traced
