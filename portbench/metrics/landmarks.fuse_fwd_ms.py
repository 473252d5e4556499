"""landmarks.fuse_fwd_ms: device milliseconds a step, in the traced half of
the window, of the kernels launched while the host was inside the
program's `ursonet.hrnet.fuse` span (the fusions' forward: their convs,
batch norms, upsampling, sums and ReLUs), each kernel put to its launch
by the profiler's correlation id (`train_landmarks.launched_within`).
None where the program has no such span."""


def read(ctx):
    if ctx.kind != 'train_landmarks' or ctx.trace is None \
            or not ctx.traced or not ctx.fuse_s:
        return None
    return 1e3 * ctx.fuse_s / ctx.traced
