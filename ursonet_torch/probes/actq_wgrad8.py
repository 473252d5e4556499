"""The int8 weight-gradient probe of TRAIN_ACT_Q8='wgrad8', the
counterpart of the JAX package's `tools/probe_actq_wgrad8.py`:

    python -m ursonet_torch.probes.actq_wgrad8 check [--device cpu]
    python -m ursonet_torch.probes.actq_wgrad8 [bench] [--reps 20]

`check` sweeps the JAX probe's geometries (kernel, stride, padding,
odd sizes, the 7x7/2 stem and the s2d stem's 4x4 with pads (2,1)):
`wgrad_s8` on int8 operands, with the quantization bypassed, against
the float64 weight gradient of autograd through `F.conv2d` on the same
values (exact: integer sums below 2^53). One JSON line per geometry;
a difference raises.

`bench` (the card) times, at the F16 flagship's shapes (ResNet-50,
batch 32, 512x640: every conv that takes the int8 route, stages 4 and
5), per distinct geometry: `wgrad_s8` (gather + gemm_s8, f32 epilogue),
`torch._int_mm` on the same patch matrix (the library yardstick; the
port never calls it), and the dequant route's weight gradient (the copy
dequantized to bf16, cuDNN's `conv2d_weight`). One JSON line each with
the bound 2 * M * N * K / 1979 TOP/s and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from ursonet_torch.device import resolve_device
from ursonet_torch.ops import actq_cuda, int8_cuda
from ursonet_torch.probes.timing import card_label, record, time_ms

INT8_OPS_PER_S = 1979e12
# (N, H, W, Ci, Co, k, stride, pad): the JAX probe's check geometries
CHECK = [(2, 8, 8, 4, 6, 3, 1, 1), (2, 9, 11, 3, 5, 3, 1, 1),
         (2, 8, 8, 4, 6, 1, 1, 0), (2, 8, 8, 4, 6, 1, 2, 0),
         (2, 16, 16, 3, 8, 7, 2, 3), (2, 12, 10, 4, 4, 3, 2, 1),
         (2, 11, 11, 12, 6, 4, 1, ((2, 1), (2, 1)))]


def flagship_geometries(batch: int = 32):
    """{name: (N, H, W, Ci, Co, k, stride, pad)} of the flagship's convs
    on the int8 route (N * Ho * Wo <= INT32_SAFE_ACC), with how many
    ResNet-50 convs share each: stage 4 at 32x40, stage 5 at 16x20."""
    geoms = {}
    for st, (h, w), f1, f3, cin, blocks in ((4, (64, 80), 256, 1024, 512, 6),
                                           (5, (32, 40), 512, 2048, 1024, 3)):
        ho, wo = h // 2, w // 2
        geoms[f'res{st}a_branch2a'] = ((batch, h, w, cin, f1, 1, 2, 0), 1)
        geoms[f'res{st}a_branch1'] = ((batch, h, w, cin, f3, 1, 2, 0), 1)
        geoms[f'res{st}_branch2b'] = ((batch, ho, wo, f1, f1, 3, 1, 1),
                                      blocks)
        geoms[f'res{st}_branch2c'] = ((batch, ho, wo, f1, f3, 1, 1, 0),
                                      blocks)
        geoms[f'res{st}_branch2a'] = ((batch, ho, wo, f3, f1, 1, 1, 0),
                                      blocks - 1)
    return geoms


def _pads(pad):
    return pad if isinstance(pad, tuple) else ((pad, pad), (pad, pad))


def operands(geom, seed: int, device):
    """int8 q [N,Ci,H,W], qgt [Co,Kp] (zero past N*Ho*Wo), the pads."""
    n, h, w, ci, co, k, s, pad = geom
    pads = _pads(pad)
    ho, wo = int8_cuda.conv_out_hw(h, w, k, k, s, pads)
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-127, 128, (n, ci, h, w), generator=gen,
                      dtype=torch.int8)
    qg = torch.randint(-127, 128, (n, co, ho, wo), generator=gen,
                       dtype=torch.int8)
    return q.to(device), actq_cuda._qgt(qg, actq_cuda.padded_k(
        n * ho * wo)).to(device), pads


def check(device) -> list:
    results = []
    for i, geom in enumerate(CHECK):
        n, h, w, ci, co, k, s, pad = geom
        q, qgt, pads = operands(geom, i, device)
        got = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads)
        # autograd of the float64 conv, g = qg
        (pt, pb), (pl, pr) = pads
        x = F.pad(q.double(), (pl, pr, pt, pb))
        wt = torch.zeros((co, ci, k, k), dtype=torch.float64, device=device,
                         requires_grad=True)
        ho, wo = int8_cuda.conv_out_hw(h, w, k, k, s, pads)
        with torch.backends.cudnn.flags(enabled=False):
            y = F.conv2d(x, wt, stride=s)
        y.backward(actq_cuda.qg_of(qgt, n, ho, wo).double())
        diff = int((got.double() - wt.grad).abs().max())
        record(results, probe='actq_wgrad8', mode='check',
               geometry=list(map(str, geom)), max_abs_diff=diff,
               device=card_label(device))
        if diff:
            raise RuntimeError(f"wgrad_s8 differs from autograd at {geom}")
    return results


def bench_row(name, geom, count, device, reps: int, card: str) -> dict:
    """Times of one geometry: wgrad_s8, torch._int_mm on its patch matrix,
    the dequant route's conv2d_weight (bf16)."""
    n, h, w, ci, co, k, s, pad = geom
    q, qgt, pads = operands(geom, 0, device)
    r = ci * k * k
    alpha = torch.full((r,), 1e-6, dtype=torch.float32, device=device)
    got = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads)
    want = actq_cuda.wgrad_s8_torch(q, qgt, (k, k), s, pads)
    err = int((got.long() - want.long()).abs().max())
    ms = time_ms(lambda: actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, alpha),
                 reps, device)
    p = actq_cuda.im2col_torch(q, (k, k), s, pads)
    lib_ms = time_ms(lambda: torch._int_mm(qgt, p.t()), reps, device)
    scale = torch.full((n,), 0.01, dtype=torch.float32, device=device)
    ho, wo = int8_cuda.conv_out_hw(h, w, k, k, s, pads)
    g = torch.randn((n, co, ho, wo), dtype=torch.bfloat16, device=device)
    wgt = torch.zeros((co, ci, k, k), dtype=torch.bfloat16, device=device)
    (pt, _), (pl, _) = pads

    def dequant_route():
        xf = actq_cuda.quant_s8(q, 'dequant', scale, dtype=torch.bfloat16)
        return torch.ops.aten.convolution_backward(
            g, xf, wgt, None, [s, s], [pt, pl], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]

    dq_ms = time_ms(dequant_route, reps, device)
    m, kk = co, qgt.shape[1]
    return {'probe': 'actq_wgrad8', 'mode': 'bench', 'name': name,
            'geometry': list(map(str, geom)), 'convs': count,
            'mnk': [m, r, kk], 'ms': ms, 'int_mm_ms': lib_ms,
            'dequant_ms': dq_ms,
            'bound_ms': 2.0 * m * r * kk / INT8_OPS_PER_S * 1e3,
            'max_abs_err': err, 'device': card}


def bench(device, reps: int) -> list:
    results = []
    card = card_label(device)
    for name, (geom, count) in flagship_geometries().items():
        row = bench_row(name, geom, count, device, reps, card)
        record(results, **row)
        if row['max_abs_err']:
            raise RuntimeError(f"wgrad_s8 differs from its plain version at "
                               f"{name}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('mode', nargs='?', default='bench',
                    choices=['check', 'bench'])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == 'check':
        check(dev)
    else:
        if dev.type != 'cuda':
            raise SystemExit("bench times the card: --device cuda")
        bench(dev, args.reps)
    return 0


if __name__ == '__main__':
    sys.exit(main())
