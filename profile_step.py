#!/usr/bin/env python3
"""Where the time of the flagship train step, or of int8 serving, goes
on the card.

    python3 profile_step.py [--serve] [--steps 3] [--seed 0] [--trace PATH]

Without --serve: builds benchmark_config(3) at full width (ResNet-50,
512×640, batch 32) as chip_smoke.py does, runs 3 warm-up steps, then
traces --steps train steps. With --serve: quantizes serving_config()
(batch 128, seeded random weights, calibrate + smooth(0.5)) as
chip_smoke.py does, serves 3 warm-up batches of device-resident uint8
images, then traces --steps served batches. Prints, with torch.profiler:
the device time by PyTorch operator and by kernel (top rows), the device
time of each kernel family, and the share of the traced window in which
the card ran no kernel. --trace writes the Chrome trace. Needs a CUDA
card.
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
FAMILIES = (
    ('warp kernel (ours)', ('warp_homography',)),
    ('int8 conv kernel (ours)', ('conv_s8_kernel',)),
    ('int8 GEMM kernel (ours)', ('gemm_s8_kernel',)),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--trace', default=None)
    ap.add_argument('--serve', action='store_true',
                    help='profile int8 serving instead of the train step')
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
        cfg = presets.serving_config()
        rng = np.random.RandomState(args.seed)
        h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
        images = rng.randint(0, 256, (cfg.BATCH_SIZE, h, w, 3), np.uint8)
        engine = ServingEngine(cfg, 'cuda', generator=torch.Generator()
                               .manual_seed(args.seed))
        engine.quantize(list(images[:8]))
        engine.qmodel.smooth(0.5)
        x = torch.from_numpy(images).cuda()

        def run(i):
            engine.qmodel(x)
        what, unit = f"served batches of {cfg.BATCH_SIZE}", "batch"
    else:
        res = cs.run_main_path(cs.flagship_config(), 'cuda', args.seed,
                               steps=3)
        step, raw = res['step'], res['raw']
        gen = torch.Generator()

        def run(i):
            step(raw, gen.manual_seed(args.seed + 10 + i))
        what, unit = "train steps", "step"
    for i in range(3 if args.serve else 0):
        run(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            run(i)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"card: {smi}; {args.steps} traced {what}, host wall "
          f"{wall_ms:.3f} ms")
    print(prof.key_averages().table(sort_by='self_device_time_total',
                                    row_limit=20))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    by_name, by_fam = {}, {}
    for k in kernels:
        dur = k.time_range.end - k.time_range.start
        by_name[k.name] = by_name.get(k.name, 0.0) + dur
        fam = family(k.name)
        by_fam[fam] = by_fam.get(fam, 0.0) + dur
    total = sum(by_fam.values())
    print(f"device kernel time: {total / 1e3 / args.steps:.3f} ms per {unit} "
          f"over {len(kernels)} kernel launches")
    for fam, us in sorted(by_fam.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:28s} {us / 1e3 / args.steps:9.3f} ms/{unit} "
              f"{us / total:7.2%}")
    print("top kernels:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / args.steps:9.3f} ms/{unit}  {name[:110]}")
    busy, window = busy_share(kernels)
    print(f"device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms "
          f"kernel window: idle share {1 - busy / window:.4f}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
