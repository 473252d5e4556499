"""serve.gemm_roofline: the least time of the 1x1 convs' and int8 denses'
GEMM calls (count.py: Σ max(ops / 1979 TOP/s, bytes / 3.35 TB/s), each
call's bytes once; bytes bound it) over the traced device time of the
int8 GEMM kernels, for the batches of the traced half of the window."""

import count


def read(ctx):
    if ctx.kind != 'serve' or ctx.trace is None:
        return None
    spent = ctx.trace.seconds_by_family().get('int8_gemm', 0.0)
    if spent <= 0:
        return None
    bound = count.serve_bound(ctx.model, ctx.height, ctx.width, ctx.batch,
                              ctx.bf16)['int8_gemm']['bound_s']
    return 100.0 * bound * ctx.traced / spent
