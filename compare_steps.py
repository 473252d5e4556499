"""Train-step or int8 kernel times of one checkout, for comparing two
trees on one card.

    python3 compare_steps.py <checkout> [--steps 2] [--reps 3] [--int8]

Imports `chip_smoke.py` of <checkout> and, for the flagship
(`benchmark_config(3)`, batch 32) in F16 and in f32, runs the train path
(`run_main_path`) and then `time_train` `--reps` times (each the median
of 10 steps after 2 warm-up). With --int8 it serves
`presets.serving_config()` (batch 128, seeded random weights, calibrated
on 8 images and smoothed) in F16 and with f32 epilogues instead: each
int8 kernel's time per served batch (`time_int8_kernels` on the calls
of one batch) and the batch's median (`time_serving`). Prints one JSON
line: the checkout and the times per mode, in ms. Run it for the parent
and the change in one call, in the order parent, change, change, parent.
"""

import argparse
import json
import os
import sys


def int8_times(chip_smoke, torch) -> dict:
    """{mode: {kernel row: ms per served batch, 'batch_ms': ms}}."""
    import numpy as np
    from ursonet_torch import presets
    from ursonet_torch.engine import ServingEngine
    from ursonet_torch.ops import int8_cuda
    dev = torch.device('cuda')
    out = {}
    for mode, f16 in (('f16', True), ('f32', False)):
        cfg = presets.serving_config(f16=f16)
        rng = np.random.RandomState(0)
        h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
        images = rng.randint(0, 256, (cfg.BATCH_SIZE, h, w, 3), np.uint8)
        engine = ServingEngine(cfg, dev,
                               generator=torch.Generator().manual_seed(0))
        qm = engine.quantize()
        qm.calibrate(images[:8])
        qm.smooth(0.5)
        int8_cuda.calls = []
        engine.predict_molded(images)
        torch.cuda.synchronize()
        calls, int8_cuda.calls = int8_cuda.calls, None
        times = chip_smoke.time_int8_kernels(calls, dev, rng, '')
        out[mode] = {k: v['ms'] for k, v in times.items()}
        out[mode]['batch_ms'] = chip_smoke.time_serving(
            engine, images, dev)['median_ms']
        del engine, qm
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('checkout')
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--int8', action='store_true',
                    help='int8 serving kernels instead of train steps')
    args = ap.parse_args(argv)
    root = os.path.abspath(args.checkout)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        sys.exit("compare_steps.py needs a CUDA device")
    out = {'checkout': args.checkout}
    if args.int8:
        out.update(int8_times(chip_smoke, torch))
        print(json.dumps(out), flush=True)
        return
    for mode, f16 in (('f16', True), ('f32', False)):
        res = chip_smoke.run_main_path(chip_smoke.flagship_config(f16=f16),
                                       torch.device('cuda'), 0, args.steps)
        out[mode] = [chip_smoke.time_train(res, 0) for _ in range(args.reps)]
        del res
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
