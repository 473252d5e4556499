"""Train-step times of one checkout, for comparing two trees on one card.

    python3 compare_steps.py <checkout> [--steps 2] [--reps 3]

Imports `chip_smoke.py` of <checkout> and, for the flagship
(`benchmark_config(3)`, batch 32) in F16 and in f32, runs the train path
(`run_main_path`) and then `time_train` `--reps` times (each the median
of 10 steps after 2 warm-up). Prints one JSON line: the checkout and the
medians per mode, in ms. Run it for the parent and the change in one
call, in the order parent, change, change, parent.
"""

import argparse
import json
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('checkout')
    ap.add_argument('--steps', type=int, default=2)
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.checkout)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        sys.exit("compare_steps.py needs a CUDA device")
    out = {'checkout': args.checkout}
    for mode, f16 in (('f16', True), ('f32', False)):
        res = chip_smoke.run_main_path(chip_smoke.flagship_config(f16=f16),
                                       torch.device('cuda'), 0, args.steps)
        out[mode] = [chip_smoke.time_train(res, 0) for _ in range(args.reps)]
        del res
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
