"""The int8 / bf16 tensor-core rate probe, the counterpart of the JAX
package's `tools/probe_int8_mxu.py`:

    python -m ursonet_torch.probes.int8_mma [--iters 512] [--reps 8]

Rows, one JSON line each:
  * `torch-matmul`: one large product outside any kernel of the port
    (`torch.matmul` in bf16, `torch._int_mm` in int8), as the TPU probe's
    XLA rows;
  * `mma-smem-loop`: `mma_rate` (csrc/mma_rate.cu) at (m, n, k) in 256^3,
    512^3, 512x512x1024, 1024x1024x512 for bf16->f32 and int8->int32, on
    each route (`route`: `wgmma`, then `mma_sync`); the rate is
    replicas * 2mnk * iters / time, `sm_clock_mhz` the SM clock read
    while the loop runs. `ms_half_iters` is the time at half the
    iterations: a loop that the compiler had hoisted would not scale
    with `iters`, so `linear` records whether the full run took 1.8 to
    2.2 times as long. int8->bf16 is recorded as unsupported: neither
    instruction has an int8 form with a bf16 accumulator.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ursonet_torch.device import resolve_device
from ursonet_torch.probes import mma_rate as mr
from ursonet_torch.probes.timing import (card_label, record, sm_clock_mhz,
                                         time_ms)

SHAPES = ((256, 256, 256), (512, 512, 512), (512, 512, 1024),
          (1024, 1024, 512))
VARIANTS = (('bf16->f32', 'bf16'), ('int8->int32', 's8'),
            ('int8->bf16', None))


def torch_matmul_row(results, name, kind, size, reps, dev, card,
                     probe='torch-matmul'):
    """One size^3 product through PyTorch's own operator."""
    a, b = mr.operands(kind, size, size, size, 1, dev)
    if kind == 'bf16':
        fn = lambda: torch.matmul(a, b)  # noqa: E731
    elif dev.type == 'cuda':
        fn = lambda: torch._int_mm(a, b)  # noqa: E731
    else:
        fn = lambda: mr.mma_rate_torch(a, b, 1, 's8')  # noqa: E731
    ms = time_ms(fn, reps, dev)
    return record(results, probe=probe, variant=name, size=size,
                  tops=2.0 * size ** 3 / ms / 1e9, ms=ms, device=card)


def loop_row(results, name, kind, mnk, iters, reps, dev, card, route,
             probe='mma-smem-loop'):
    """One timed resident loop on one route; also timed at half the
    iterations, and the SM clock read while it runs."""
    m, n, k = mnk
    a, b = mr.operands(kind, m, n, k, 0, dev)
    out = mr.mma_rate(a, b, iters, kind, all_replicas=True, route=route)
    replicas = out.shape[0]
    del out

    def run():
        return mr.mma_rate(a, b, iters, kind, route=route)
    ms = time_ms(run, reps, dev)
    half = time_ms(lambda: mr.mma_rate(a, b, iters // 2, kind, route=route),
                   reps, dev)
    return record(results, probe=probe, variant=name, route=route,
                  mnk=[m, n, k], iters=iters, replicas=replicas,
                  tile=list(mr.tile_for(kind, k, route)),
                  tops=replicas * 2.0 * m * n * k * iters / ms / 1e9, ms=ms,
                  ms_half_iters=half, linear=bool(1.8 <= ms / half <= 2.2),
                  sm_clock_mhz=sm_clock_mhz(run, ms, dev), device=card)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=512)
    ap.add_argument('--reps', type=int, default=8)
    ap.add_argument('--matmul-size', type=int, default=8192)
    ap.add_argument('--max-dim', type=int, default=1024,
                    help='skip loop shapes with a larger m, n or k')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    results: list = []
    for name, kind in VARIANTS[:2]:
        torch_matmul_row(results, name, kind, args.matmul_size, 4, dev, card)
    for mnk in SHAPES:
        if max(mnk) > args.max_dim:
            continue
        for name, kind in VARIANTS:
            for route in mr.ROUTES:
                if kind is None:
                    record(results, probe='mma-smem-loop', variant=name,
                           route=route, mnk=list(mnk),
                           error=f'unsupported: {route} has no int8 form '
                           'with a bf16 accumulator', device=card)
                    continue
                loop_row(results, name, kind, mnk, args.iters, args.reps,
                         dev, card, route)
    return results


if __name__ == '__main__':
    main()
    sys.exit(0)
