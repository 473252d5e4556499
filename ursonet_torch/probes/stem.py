"""The fused int8 stem probe, the counterpart of the JAX package's
`tools/probe_pallas_stem.py` (its on-chip timing):

    python -m ursonet_torch.probes.stem [--batch 128] [--h 512] [--w 640]

Rows, one JSON line each:
  * `stem_s8`, once per route of `ops.int8_cuda.stem_s8` (`tma`, then
    `ragged`): the whole stem section of the s2d serving variants in one
    launch, on seeded space-to-depth uint8 pixels [B, H/2, W/2, 12] in
    the `calibrated` input mode; `max_lsb_diff_vs_plain` over the first
    `--check-batch` images against `stem_s8_torch`, `tops` the conv's
    2 * B * H/2 * W/2 * 192 * 64 operations over the time, `sm_clock_mhz`
    the SM clock read while it runs. A width the `tma` route does not
    take (W/2 % 4 != 0) is recorded as unsupported;
  * `unfused-7x7`: the unfused stem section on [B, H, W, 3] pixels (the
    `base` variant's before stem_s8's 'nhwc' route, and still a float
    molded batch's): input quantize, the 7x7/2 conv through `conv_s8`
    (q8_relu), the 3x3/2 maxpool (as the TPU probe timed XLA's
    section).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ursonet_torch.device import resolve_device
from ursonet_torch.ops import int8_cuda
from ursonet_torch.probes.timing import (card_label, record, sm_clock_mhz,
                                         time_ms)

MEAN3 = np.array([123.7, 116.8, 103.9], np.float32)


def operands(b, h2, w2, seed, device):
    """Packed u8 pixels, an s2d stem kernel (HWIO view) and the calibrated
    mode's arguments: the flagship pixel mean, an input step of 1.09, and
    alpha, beta that spread the requantized values over 0..127."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (b, h2, w2, 12), np.uint8))
    w = int8_cuda.kernel_layout(
        rng.randint(-127, 128, (4, 4, 12, 64)).astype(np.int8))
    alpha = rng.uniform(0.5, 1.5, 64) * 0.6 / (np.sqrt(192) * 128 * 100 / 3)
    kw = dict(alpha=torch.from_numpy(alpha.astype(np.float32)).to(device),
              beta=torch.from_numpy(
                  rng.uniform(-1, 1, 64).astype(np.float32)).to(device),
              inv_s_out=float(np.float32(1) / np.float32(3.0 / 127)),
              mode='calibrated', mean=np.tile(MEAN3, 4),
              inv_s_in=float(np.float32(1) / np.float32(1.09)))
    return x.to(device), w.to(device), kw


def stem_row(results, route, x, w, kw, check_batch, reps, dev, card):
    b, h2, w2, _ = x.shape
    if route == 'tma' and int8_cuda.stem_route(w2) != 'tma':
        return record(results, probe='stem_s8', route=route,
                      shape=list(x.shape), error='unsupported: W/2 % 4 != 0',
                      device=card)
    got = int8_cuda.stem_s8(x[:check_batch], w, route=route, **kw)
    want = int8_cuda.stem_s8_torch(x[:check_batch], w, **kw)
    diff = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())

    def run():
        return int8_cuda.stem_s8(x, w, route=route, **kw)
    ms = time_ms(run, reps, dev)
    return record(results, probe='stem_s8', route=route, shape=list(x.shape),
                  mode=kw['mode'], ms=ms,
                  tops=2.0 * b * h2 * w2 * 192 * 64 / ms / 1e9,
                  max_lsb_diff_vs_plain=diff,
                  sm_clock_mhz=sm_clock_mhz(run, ms, dev), device=card)


def unfused_row(results, b, h, w, reps, dev, card, seed=1):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3), np.uint8)).to(dev)
    w7 = int8_cuda.kernel_layout(
        rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)).to(dev)
    alpha = torch.from_numpy((rng.uniform(0.5, 1.5, 64) * 2e-4)
                             .astype(np.float32)).to(dev)
    beta = torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32)) \
        .to(dev)

    def section():
        q, _ = int8_cuda.stem_input_s8(x, 'calibrated', MEAN3, 1 / 1.09)
        y = int8_cuda.conv_s8(q, w7, 2, ((3, 3), (3, 3)), 'q8_relu',
                              alpha, beta, 127 / 3.0)
        return int8_cuda.maxpool_s8(y)
    ms = time_ms(section, reps, dev)
    return record(results, probe='unfused-7x7', shape=[b, h, w, 3], ms=ms,
                  device=card)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--h', type=int, default=512)
    ap.add_argument('--w', type=int, default=640)
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--check-batch', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_label(dev)
    x, w, kw = operands(args.batch, args.h // 2, args.w // 2, args.seed, dev)
    results: list = []
    for route in int8_cuda.ROUTES:
        stem_row(results, route, x, w, kw, args.check_batch, args.reps, dev,
                 card)
    unfused_row(results, args.batch, args.h, args.w, args.reps, dev, card)
    return results


if __name__ == '__main__':
    main()
    sys.exit(0)
