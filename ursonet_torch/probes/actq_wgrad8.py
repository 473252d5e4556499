"""The int8 weight-gradient probe of TRAIN_ACT_Q8='wgrad8', the
counterpart of the JAX package's `tools/probe_actq_wgrad8.py`:

    python -m ursonet_torch.probes.actq_wgrad8 check [--device cpu]
    python -m ursonet_torch.probes.actq_wgrad8 [bench] [--reps 20]
    python -m ursonet_torch.probes.actq_wgrad8 variants
    python -m ursonet_torch.probes.actq_wgrad8 dequant

`check` sweeps the JAX probe's geometries (kernel, stride, padding,
odd sizes, the 7x7/2 stem and the s2d stem's 4x4 with pads (2,1)):
`wgrad_s8` on int8 operands, with the quantization bypassed, against
the float64 weight gradient of autograd through `F.conv2d` on the same
values (exact: integer sums below 2^53). One JSON line per geometry;
a difference raises.

`bench` (the card) times, at the F16 flagship's shapes (ResNet-50,
batch 32, 512x640: every conv that takes the int8 route, stages 4 and
5), per distinct geometry: `wgrad_s8` on its route (the TMA route's
implicit GEMM on q and qgt in the plan's layouts, f32 epilogue), the
ragged route (gather + gemm_s8) on the same values, `torch._int_mm` on
the patch matrix (the library yardstick; the port never calls it), and
the dequant route's weight gradient (the copy dequantized to bf16,
cuDNN's `conv2d_weight`). One JSON line each with the route, the bound
2 * M * N * K / 1979 TOP/s over the valid columns and the card's name
and power limit.

`variants` (the card) times by CUDA graph, at the same geometries, the
TMA route at each tile width it can take and a few K splits around the
chosen one (each equal to the chosen one's sums), the data that
`actq_cuda.wgrad_split_cost` was fitted to; and `quant_s8` 'x' at the
flagship's conv-input shapes as the path runs it (a true division by
the scale) and with the division replaced by a multiply by the scale's
reciprocal (`_quant_launch(timing_mul=True)`: other bits, timed only),
beside the time of its bytes at the card's memory rate: whether the
division or the bytes bind the quantize; and the 'dequant' kernel
(`dequant` alone) at those shapes in bf16 and f32, beside one torch.mul
of the same function, PyTorch's cast of q to the output type (the same
bytes moved) and the bytes' time.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from ursonet_torch.device import resolve_device
from ursonet_torch.ops import actq_cuda, int8_cuda
from ursonet_torch.probes.timing import card_label, graph_ms, record, time_ms

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


def recipe_geometries(config) -> dict:
    """{name: ((N, H, W, Ci, Co, k, stride, pad), count)} of the
    backbone convs of `config`'s train step (`memory.backbone_convs`)
    whose weight gradient takes the int8 route ('wgrad8', N * Ho * Wo
    within the int32 guard), with how many convs share each; named
    `n{N}_{Ci}x{H}x{W}_k{k}s{stride}_co{Co}`."""
    from ursonet_torch.utils import memory
    geoms = {}
    for n, ci, h, w, co, k, s, p in memory.backbone_convs(config):
        ho, wo = int8_cuda.conv_out_hw(h, w, k, k, s, ((p, p), (p, p)))
        if n * ho * wo > actq_cuda.INT32_SAFE_ACC:
            continue
        name = f'n{n}_{ci}x{h}x{w}_k{k}s{s}_co{co}'
        geom, count = geoms.get(name, ((n, h, w, ci, co, k, s, p), 0))
        geoms[name] = (geom, count + 1)
    return geoms


def _pads(pad):
    return pad if isinstance(pad, tuple) else ((pad, pad), (pad, pad))


def operands(geom, seed: int, device, route=None):
    """int8 q and qg of a geometry, in the layouts of its `wgrad_plan`
    (`route` forced, or chosen from the shapes): (q, qgt, pads, plan)."""
    n, h, w, ci, co, k, s, pad = geom
    pads = _pads(pad)
    plan = actq_cuda.wgrad_plan((n, ci, h, w), co, (k, k), s, pads, route)
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-127, 128, (n, ci, h, w), generator=gen,
                      dtype=torch.int8).to(device)
    qg = torch.randint(-127, 128, (n, co, plan.ho, plan.wo), generator=gen,
                       dtype=torch.int8).to(device)
    return actq_cuda.to_layout(q, plan), actq_cuda._qgt(qg, plan=plan), \
        pads, plan


def check(device) -> list:
    results = []
    for i, geom in enumerate(CHECK):
        n, h, w, ci, co, k, s, pad = geom
        q, qgt, pads, plan = operands(geom, i, device)
        got = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, plan=plan)
        # autograd of the float64 conv, g = qg
        (pt, pb), (pl, pr) = pads
        x = F.pad(actq_cuda.q_of(q, plan).double(), (pl, pr, pt, pb))
        wt = torch.zeros((co, ci, k, k), dtype=torch.float64, device=device,
                         requires_grad=True)
        ho, wo = int8_cuda.conv_out_hw(h, w, k, k, s, pads)
        with torch.backends.cudnn.flags(enabled=False):
            y = F.conv2d(x, wt, stride=s)
        y.backward(actq_cuda.qg_of(qgt, n, ho, wo, plan).double())
        diff = int((got.double() - wt.grad).abs().max())
        record(results, probe='actq_wgrad8', mode='check',
               geometry=list(map(str, geom)), route=plan.route,
               max_abs_diff=diff, device=card_label(device))
        if diff:
            raise RuntimeError(f"wgrad_s8 differs from autograd at {geom}")
    return results


def bench_row(name, geom, count, device, reps: int, card: str) -> dict:
    """Times of one geometry: wgrad_s8 on its route and on the ragged
    route, torch._int_mm on the patch matrix, the dequant route's
    conv2d_weight (bf16)."""
    n, h, w, ci, co, k, s, pad = geom
    q, qgt, pads, plan = operands(geom, 0, device)
    rq, rqgt, _, rplan = operands(geom, 0, device, 'ragged')
    r = ci * k * k
    alpha = torch.full((r,), 1e-6, dtype=torch.float32, device=device)
    got = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, plan=plan)
    want = actq_cuda.wgrad_s8_torch(q, qgt, (k, k), s, pads, plan)
    err = int((got.long() - want.long()).abs().max())
    ms = time_ms(lambda: actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, alpha,
                                            plan=plan), reps, device)
    ragged_ms = time_ms(lambda: actq_cuda.wgrad_s8(
        rq, rqgt, (k, k), s, pads, alpha, plan=rplan), reps, device)
    p = actq_cuda.im2col_torch(rq, (k, k), s, pads)
    lib_ms = time_ms(lambda: torch._int_mm(rqgt, p.t()), reps, device)
    del p
    scale = torch.full((n,), 0.01, dtype=torch.float32, device=device)
    ho, wo = plan.ho, plan.wo
    g = torch.randn((n, co, ho, wo), dtype=torch.bfloat16, device=device)
    wgt = torch.zeros((co, ci, k, k), dtype=torch.bfloat16, device=device)
    (pt, _), (pl, _) = pads

    def dequant_route():
        xf = actq_cuda.quant_s8(rq, 'dequant', scale, dtype=torch.bfloat16)
        return torch.ops.aten.convolution_backward(
            g, xf, wgt, None, [s, s], [pt, pl], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]

    dq_ms = time_ms(dequant_route, reps, device)
    return {'probe': 'actq_wgrad8', 'mode': 'bench', 'name': name,
            'geometry': list(map(str, geom)), 'convs': count,
            'route': plan.route, 'mnk': [co, r, n * ho * wo],
            'kp': plan.kp, 'q_bytes': q.numel(), 'ms': ms,
            'ragged_ms': ragged_ms, 'int_mm_ms': lib_ms,
            'dequant_ms': dq_ms,
            'bound_ms': 2.0 * co * r * n * ho * wo / INT8_OPS_PER_S * 1e3,
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


def wgrad_variants(device, card: str) -> list:
    """Device time of the TMA route per flagship geometry at each tile
    width and a few splits (1, half, the chosen, double)."""
    results = []
    lib = actq_cuda._lib()
    sms = int8_cuda._sms(device)
    for name, (geom, count) in flagship_geometries().items():
        n, h, w, ci, co, k, s, pad = geom
        q, qgt, pads, plan = operands(geom, 0, device)
        auto = actq_cuda.wgrad_tiles(plan, sms)
        want = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, plan=plan)
        row = {'probe': 'actq_wgrad8', 'mode': 'variants', 'name': name,
               'convs': count, 'chosen': [auto['bn'], auto['splits']],
               'device': card}
        for bn in (128, 256) if ci % 256 == 0 else (128,):
            best = actq_cuda.wgrad_tiles(plan, sms, bn=bn)['splits']
            for d in sorted({1, max(1, best // 2), best, 2 * best}):
                t = actq_cuda.wgrad_tiles(plan, sms, bn=bn, splits=d)
                if (d - 1) * t['kps'] >= t['ksteps']:
                    continue
                out = torch.empty((co, ci * k * k), dtype=torch.int32,
                                  device=device)
                ws = torch.empty(d * t['tiles'] * 128 * bn, dtype=torch.int32,
                                 device=device)
                cnt = torch.zeros(2 * t['tiles'], dtype=torch.int32,
                                  device=device)
                (pt, _), _ = pads

                def call():
                    actq_cuda._raise_if(lib.ursonet_actq_wgrad_tma(
                        q.data_ptr(), qgt.data_ptr(), None, out.data_ptr(),
                        ws.data_ptr(), cnt.data_ptr(), n, ci, plan.hk,
                        plan.copies, plan.wph, co, k, k, s, pt,
                        int(plan.cmaj), plan.wst, plan.kps, plan.kp, bn, d,
                        t['grid'], torch.cuda.current_stream().cuda_stream),
                        lib, 'wgrad_s8')

                call()
                if not torch.equal(out.view_as(want), want):
                    raise RuntimeError(f"{name}: {bn}x{d} differs")
                row[f'{bn}x{d}_ms'] = graph_ms(call)
        record(results, **row)
    return results


def quant_variants(device, card: str) -> list:
    """Device time of quant_s8 'x' at the F16 flagship's conv-input
    shapes dividing by the scale (the path) and multiplying by its
    reciprocal (timing only; the bits differ), and 'dequant' on the
    same elements."""
    results = []
    lib = actq_cuda._lib()
    sms = int8_cuda._sms(device)
    for shape in ((32, 3, 512, 640), (32, 64, 128, 160), (32, 256, 128, 160),
                  (32, 512, 64, 80), (32, 256, 32, 40), (32, 1024, 32, 40),
                  (32, 512, 16, 20), (32, 2048, 16, 20)):
        x = (torch.randn(shape, device=device) * 3).to(torch.bfloat16)
        rv = actq_cuda.quant_rows('x', shape)
        q = torch.empty(shape, dtype=torch.int8, device=device)
        scale = torch.empty(shape[0], dtype=torch.float32, device=device)
        ws = actq_cuda._workspace(actq_cuda._quant_ws, device, 2 + shape[0])
        row = {'probe': 'actq_wgrad8', 'mode': 'variants', 'quant_x': shape,
               'bound_ms': 3 * x.numel() / 3.35e12 * 1e3, 'device': card}
        sched = actq_cuda.quant_plan(rv['rows'], rv['w'], 2,
                                     actq_cuda.quant_vec(rv, 2), sms)
        for key, mul in (('divide_ms', False), ('multiply_ms', True)):
            row[key] = graph_ms(
                lambda mul=mul: actq_cuda._raise_if(actq_cuda._quant_launch(
                    lib, x, 'x', 3, None, q, scale, 0, rv, sched, ws,
                    timing_mul=mul), lib, 'quant_s8'))
        # the path's quantize (a true division) on the same x, bit for
        # bit, and the dequant of its q (the same bytes moved)
        got = actq_cuda.quant_s8(x, 'x')
        want = actq_cuda.quant_s8_torch(x, 'x')
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"quant_s8 'x' {shape} differs from its "
                               "plain version")
        row['dequant_ms'] = graph_ms(
            lambda: actq_cuda.quant_s8(got[0], 'dequant', got[1],
                                       dtype=torch.bfloat16))
        record(results, **row)
    return results


DEQUANT_SHAPES = ((32, 3, 512, 640), (32, 64, 128, 160), (32, 256, 128, 160),
                  (32, 512, 64, 80), (32, 256, 32, 40), (32, 1024, 32, 40),
                  (32, 512, 16, 20), (32, 2048, 16, 20))


def dequant_times(device, card: str, shapes=DEQUANT_SHAPES,
                  dtypes=(torch.bfloat16, torch.float32)) -> list:
    """Device time by CUDA graph of quant_s8 'dequant''s kernel (first
    checked equal to dequant_torch bit for bit) at the F16 flagship's
    conv-input shapes, beside the one torch.mul call of the same function
    (its bits checked too), PyTorch's cast of q to the output type and
    the bound: q and the scales read, out written once, at the card's
    memory rate."""
    results = []
    lib = actq_cuda._lib()
    gen = torch.Generator().manual_seed(5)
    for shape in shapes:
        q = torch.randint(-128, 128, shape, generator=gen,
                          dtype=torch.int8).to(device)
        scale = (torch.rand(shape[0], generator=gen) + 0.01).to(device)
        for dt in dtypes:
            want = actq_cuda.dequant_torch(q, scale, dt)
            out = torch.zeros_like(want)

            def call():
                actq_cuda._raise_if(actq_cuda._dequant_launch(
                    lib, q, scale, out), lib, 'quant_s8')
            call()
            if not torch.equal(out, want):
                raise RuntimeError(f"dequant {shape} {dt} differs from its "
                                   "plain version")
            nbytes = q.numel() * (1 + want.element_size()) + 4 * shape[0]
            mul = (lambda: torch.mul(q, scale.to(dt).view(-1, 1, 1, 1)))
            # PyTorch's cast q -> dt: the same bytes read and written, no
            # scale (what the card's memory gives this mix of traffic)
            record(results, probe='actq_wgrad8', mode='dequant',
                   dequant=shape, dtype=str(dt).split('.')[-1],
                   bound_ms=nbytes / 3.35e12 * 1e3, kernel_ms=graph_ms(call),
                   mul_equal=torch.equal(mul(), want), mul_ms=graph_ms(mul),
                   cast_ms=graph_ms(lambda: q.to(dt)), device=card)
            del want, out
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('mode', nargs='?', default='bench',
                    choices=['check', 'bench', 'variants', 'dequant'])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == 'check':
        check(dev)
    elif dev.type != 'cuda':
        raise SystemExit(f"{args.mode} times the card: --device cuda")
    elif args.mode == 'bench':
        bench(dev, args.reps)
    elif args.mode == 'dequant':
        dequant_times(dev, card_label(dev))
    else:
        card = card_label(dev)
        wgrad_variants(dev, card)
        quant_variants(dev, card)
        dequant_times(dev, card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
