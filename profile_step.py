#!/usr/bin/env python3
"""Where the time of a train step, or of int8 serving, goes on the card.

    python3 profile_step.py [--config {3,5}] [--f16]
                            [--serve [--variant base host_s2d]
                             [--f32-epilogues]] [--steps 3] [--seed 0]
                            [--trace PATH]

Without --serve: builds benchmark_config(--config) at full width as
chip_smoke.py does (3: the flagship recipe, ResNet-50, 512×640, batch
32, f32 unless --f16; 5: ResNet-101, the 3-keypoint head, F16, REMAT,
batch 16), runs 3 warm-up steps, then traces --steps train steps. With
--serve: quantizes serving_config()
(batch 128, F16: the bf16 epilogues, or the f32 ones with
--f32-epilogues; seeded random weights, calibrate + smooth(0.5)) as
chip_smoke.py does, serves 3 warm-up batches of device-resident uint8
images, then traces --steps served batches; --variant names one or more
of the serving variants (base, s2d, host_s2d), profiled one after the
other in the same process, so the variants read side by side. Prints,
with torch.profiler: the device time by PyTorch operator and by kernel
(top rows), the device time of each kernel family, the share of the
traced window in which the card ran no kernel, and the host and device
milliseconds of each of the program's spans (`ursonet_torch/utils/
profiling.py`: a served batch's stem section, stages and heads; a train
step's gather, preprocess, forward, backward and update). --trace writes
the Chrome trace (of the last variant). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from ursonet_torch import presets
from ursonet_torch.engine import ServingEngine

# Kernel families by substrings of the kernel name, first match wins.
# gemm_s8 and conv_s8 each have two kernels, reported apart: the
# persistent TMA + wgmma one, `tma_s8_kernel<BN, kConv>` (kConv false for
# the GEMM, true for the conv), and the mma.sync one of the ragged route;
# so has stem_s8 (`stem_s8_tma_kernel`, `stem_s8_kernel`), whose TMA
# kernel's second template flag is its 'nhwc' route (the raw batch).
FAMILIES = (
    ('warp kernel (ours)', ('warp_homography',)),
    ('int8 stem kernel, nhwc route (ours)',
     tuple(f'stem_s8_tma_kernel<{b}, true>' for b in ('true', 'false'))),
    ('int8 stem kernel, TMA + wgmma route (ours)', ('stem_s8_tma_kernel',)),
    ('int8 stem kernel, mma.sync route (ours)', ('stem_s8_kernel',)),
    # tma_s8_kernel<BN, conv, bf16 epilogues>
    ('int8 conv kernel, TMA + wgmma route (ours)',
     tuple(f'tma_s8_kernel<{bn}, true,' for bn in (64, 128, 256))),
    ('int8 GEMM kernel, TMA + wgmma route (ours)',
     tuple(f'tma_s8_kernel<{bn}, false,' for bn in (64, 128, 256))),
    ('int8 conv kernel, mma.sync route (ours)', ('conv_s8_kernel',)),
    ('int8 GEMM kernel, mma.sync route (ours)', ('gemm_s8_kernel',)),
    ('maxpool', ('max_pool',)),
    ('conv wgrad', ('wgrad',)),
    ('conv dgrad', ('dgrad',)),
    ('conv fprop / other cuDNN', ('fprop', 'conv', 'cudnn', 'xmma',
                                  'implicit', 'nchwToNhwc', 'nhwcToNchw')),
    ('dense GEMM', ('gemm', 'cutlass', 'sgemm', 'splitK')),
    ('batch norm', ('batch_norm', 'bn_fw', 'bn_bw', 'batchnorm')),
    ('reductions', ('reduce',)),
    ('elementwise / copies', ('elementwise', 'vectorized', 'copy',
                              'Memcpy', 'Memset', 'fill')),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return 'other'


def busy_share(kernels) -> tuple[float, float]:
    """(union of kernel intervals, window) in µs over the traced kernels."""
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0] if spans else 0.0


def device_kernels(prof):
    """The device operations: not the GPU-side annotations of spans."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def span_table(prof, steps, unit) -> None:
    """The program's spans, ms per step or batch: the host's range, and
    the device's from the span's GPU-side annotation, in order of first
    start. The annotation runs from the first to the last kernel
    launched from inside the span and not from a nested one, nor from
    another thread: a parent span (a step, a forward) and the backward,
    whose kernels autograd's device thread launches, read about 0."""
    cuda = torch.autograd.DeviceType.CUDA
    host, dev, first = {}, {}, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if not name.startswith('ursonet.'):
            continue
        into = dev if ev.device_type() == cuda else host
        into[name] = into.get(name, 0.0) + (ev.end_ns() - ev.start_ns()) / 1e6
        first[name] = min(first.get(name, ev.start_ns()), ev.start_ns())
    print(f"program spans, ms per {unit}: host, device")
    for name in sorted(host, key=first.get):
        print(f"  {name:26s} {host[name] / steps:9.3f} "
              f"{dev.get(name, 0.0) / steps:9.3f}")


def report(prof, steps, unit, trace=None) -> None:
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=20))
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    by_name, by_fam = {}, {}
    for k in kernels:
        dur = k.time_range.end - k.time_range.start
        by_name[k.name] = by_name.get(k.name, 0.0) + dur
        fam = family(k.name)
        by_fam[fam] = by_fam.get(fam, 0.0) + dur
    total = sum(by_fam.values())
    print(f"device kernel time: {total / 1e3 / steps:.3f} ms per {unit} "
          f"over {len(kernels)} kernel launches")
    for fam, us in sorted(by_fam.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:46s} {us / 1e3 / steps:9.3f} ms/{unit} "
              f"{us / total:7.2%}")
    print("top kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / steps:9.3f} ms/{unit}  {name[:110]}")
    busy, window = busy_share(kernels)
    print(f"device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms "
          f"kernel window: idle share {1 - busy / window:.4f}")
    span_table(prof, steps, unit)
    if trace:
        prof.export_chrome_trace(trace)
        print(f"trace: {trace}")


def traced(run, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            run(i)
        torch.cuda.synchronize()
    return prof, (time.perf_counter() - t0) * 1e3


def profile_serving(variant, args, smi) -> None:
    cfg = presets.serving_config(variant=variant, f16=not args.f32_epilogues)
    rng = np.random.RandomState(args.seed)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    images = rng.randint(0, 256, (cfg.BATCH_SIZE, h, w, 3), np.uint8)
    engine = ServingEngine(cfg, 'cuda', generator=torch.Generator()
                           .manual_seed(args.seed))
    engine.quantize(list(images[:8]))
    engine.qmodel.smooth(0.5)
    x = torch.from_numpy(engine._host_s2d_maybe(images)).cuda()
    qm = engine.qmodel
    for _ in range(3):
        qm(x)
    prof, wall_ms = traced(lambda i: qm(x), args.steps)
    print(f"card: {smi}; serve [{variant} "
          f"{'f32' if args.f32_epilogues else 'bf16'} epilogues]: "
          f"{args.steps} traced served "
          f"batches of {cfg.BATCH_SIZE}, host wall {wall_ms:.3f} ms")
    report(prof, args.steps, 'batch', args.trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--trace', default=None)
    ap.add_argument('--serve', action='store_true',
                    help='profile int8 serving instead of the train step')
    ap.add_argument('--variant', nargs='+', default=['base'],
                    choices=presets.SERVING_VARIANTS,
                    help='with --serve: the serving variants to profile')
    ap.add_argument('--f32-epilogues', action='store_true',
                    help='with --serve: the f32-epilogue mode, not F16')
    ap.add_argument('--config', type=int, choices=(3, 5), default=3,
                    help='the benchmark configuration to train')
    ap.add_argument('--f16', action='store_true',
                    help='train in bf16 (F16; config 5 always is)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.serve:
        for variant in args.variant:
            profile_serving(variant, args, smi)
            torch.cuda.empty_cache()
        return 0
    if args.config == 3:
        cfg = cs.flagship_config(f16=args.f16)
    else:
        cfg = presets.benchmark_config(5)
    res = cs.run_main_path(cfg, 'cuda', args.seed, steps=3)
    step, raw = res['step'], res['raw']
    gen = torch.Generator()
    prof, wall_ms = traced(
        lambda i: step(raw, gen.manual_seed(args.seed + 10 + i)), args.steps)
    print(f"card: {smi}; config {args.config} "
          f"{'bf16' if cfg.F16 else 'f32'}, batch {cfg.BATCH_SIZE}, REMAT "
          f"{cfg.REMAT}: {args.steps} traced train steps, host wall "
          f"{wall_ms:.3f} ms")
    report(prof, args.steps, 'step', args.trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
