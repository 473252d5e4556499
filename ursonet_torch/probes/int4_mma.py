"""The int4 tensor-core rate probe, the counterpart of the JAX package's
`tools/probe_int4_mxu.py`:

    python -m ursonet_torch.probes.int4_mma [--iters 512] [--reps 8]

Operands are int8 tensors holding int4-range values; the kernel packs
them to int4 once in its prologue, as the Pallas kernel narrowed them.
Rows, one JSON line each:
  * `torch-dot`: one size^3 product through PyTorch's own operator, bf16
    and int8; int4 and w4a8 are recorded as unsupported (PyTorch has no
    int4 matrix product);
  * `conv-C4-3x3`: the C4 3x3 convolution at the flagship serving shape
    (128 x 32 x 40, 512 -> 512) through `conv_s8` with s32 output; int4
    and w4a8 unsupported likewise;
  * `mma-smem-loop`: `mma_rate` at 512^3 and 1024x1024x512 for int8 and
    int4, on each route. Hopper's `wgmma` has no int4 form: its route
    sign-extends the int4 values to int8 while staging and runs the s8
    loop (the same sums); the `mma_sync` route runs
    `mma.sync.m16n8k64.s4`, the record that the card has no int4 rate.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ursonet_torch.device import resolve_device
from ursonet_torch.ops import int8_cuda
from ursonet_torch.probes import mma_rate
from ursonet_torch.probes.int8_mma import loop_row, torch_matmul_row
from ursonet_torch.probes.timing import card_label, record, time_ms

SHAPES = ((512, 512, 512), (1024, 1024, 512))
NO_INT4 = 'unsupported: PyTorch has no int4 operator for this'


def conv_row(results, batch, reps, dev, card, hw=(32, 40), c=512):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randint(-127, 128, (batch,) + hw + (c,))
                         .astype(np.int8)).to(dev)
    w = int8_cuda.kernel_layout(
        rng.randint(-127, 128, (3, 3, c, c)).astype(np.int8)).to(dev)
    ms = time_ms(lambda: int8_cuda.conv_s8(x, w, 1, ((1, 1), (1, 1)), 's32'),
                 reps, dev)
    ops = 2.0 * batch * hw[0] * hw[1] * c * c * 9
    return record(results, probe='conv-C4-3x3', variant='int8',
                  tops=ops / ms / 1e9, ms=ms, device=card)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=512)
    ap.add_argument('--reps', type=int, default=8)
    ap.add_argument('--matmul-size', type=int, default=8192)
    ap.add_argument('--conv-batch', type=int, default=128)
    ap.add_argument('--conv-channels', type=int, default=512)
    ap.add_argument('--max-dim', type=int, default=1024,
                    help='skip loop shapes with a larger m, n or k')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    results: list = []
    for name, kind in (('bf16', 'bf16'), ('int8', 's8')):
        torch_matmul_row(results, name, kind, args.matmul_size, 4, dev, card,
                         probe='torch-dot')
    for name in ('int4', 'w4a8'):
        record(results, probe='torch-dot', variant=name, error=NO_INT4,
               device=card)
    conv_row(results, args.conv_batch, args.reps, dev, card,
             c=args.conv_channels)
    for name in ('int4', 'w4a8'):
        record(results, probe='conv-C4-3x3', variant=name, error=NO_INT4,
               device=card)
    for name, kind in (('int8', 's8'), ('int4', 's4')):
        for mnk in SHAPES:
            if max(mnk) > args.max_dim:
                continue
            for route in mma_rate.ROUTES:
                loop_row(results, name, kind, mnk, args.iters, args.reps,
                         dev, card, route)
    return results


if __name__ == '__main__':
    main()
    sys.exit(0)
