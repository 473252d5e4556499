"""serve.batch_p95_ms: the 95th percentile of the batches' host times in
the untraced half of the window, from handing the batch to
`predict_molded` until its heads are on the host. Per-layer and not end to
end: across processes it spreads by more than the benchmark's largest
bound allows (the pageable copy rides the host's memory bandwidth)."""

import timing


def read(ctx):
    if ctx.kind != 'serve' or not ctx.lat_s:
        return None
    return 1e3 * timing.p95(ctx.lat_s)
