#!/usr/bin/env python3
"""Read a cell's correctness check on the card over many seeds in one
process: for each seed, one run of the cell with a short window, which
reads the numbers compared as the benchmark does.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \
        [--seconds 3] [--fault NAME]

One JSON line per seed: `correct` and the numbers compared, each with its
limit. Without `--fault` the program runs as the benchmark runs it (the
lower readings of the limits); with `--fault control` the plain reference
computed one precision below the configuration's (int4 where it serves
int8, fp8 products where it trains in bf16) stands in the program's
place, and with another name of `faults.py` that fault is planted under
the timed path: both have to read `correct` false. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--fault', default=None)
    args = ap.parse_args(argv)
    run.setup_paths()
    import cells
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    import faults
    cell = cells.load_cell(args.workload)
    hooks = {} if args.fault is None \
        else {'fault': faults.fault(cell, args.fault)}
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run.measure(cell, seed, args.seconds, False, 'cuda:0', t0=t0,
                          **hooks)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'fault': args.fault,
                          'correct': res['correct'],
                          'checks': res['checks'], 'setup': res['setup'],
                          'seconds': time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
