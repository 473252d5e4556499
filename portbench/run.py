#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's files are found by name
(`cells.py`); its traffic kind (`serve`, `train`) drives the program
(`ursonet_torch`), times set-up and a window of `--seconds`, and checks
what the window produced against the plain reference. With `--trace 0`
the result carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from a profiler trace of the window, and a
breakdown of the device's time.

The last line of standard output is the result, one JSON object; the
numbers compared for `correct`, each beside its limit, are the last key
there and the last lines of standard error. Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# Build and kernel caches at fixed places inside the checkout, so that
# only a checkout's first run builds.
CACHES = {'TORCH_EXTENSIONS_DIR': 'torch_extensions',
          'TRITON_CACHE_DIR': 'triton', 'CUDA_CACHE_PATH': 'nv'}
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ursonet_tpu')


def setup_paths() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(REPO / '.portbench_cache' / sub)
    for p in (str(REPO), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t0: float = T0, **hooks) -> dict:
    """One run of `cell` on `device`; returns the result object. On the
    CPU (the tests) device metrics are left out and per-layer metrics are
    refused: a trace of the CPU says nothing of the card. On the card,
    set-up first builds what the checkout has not built of the program's
    CUDA sources; its seconds are `setup['build']`, apart from the other
    phases of set-up (all of them are in `setup_s`)."""
    import torch
    import cells
    import timing
    driver = importlib.import_module(cell.kind)
    dev = torch.device(device)
    if trace and dev.type != 'cuda':
        raise RuntimeError("per-layer metrics are device metrics: a CPU "
                           "run does not report them")
    phases = timing.Phases(t0)
    phases.mark('imports')
    if dev.type == 'cuda':
        import program
        program.build_kernels()
        phases.mark('build')
    run = driver.run(cell, seed, seconds, trace, dev, phases, **hooks)
    correct = all(c['value'] <= c['limit'] for c in run.checks.values())
    if trace:
        metrics = cells.read_per_layer(cell, run.ctx)
    else:
        names = {m['name'] for m in cell.end_to_end}
        metrics = {k: v for k, v in run.metrics.items()
                   if k in names or not names}
    result = {'correct': bool(correct), 'attempted': run.attempted,
              'failed': run.failed, 'metrics': metrics}
    if dev.type == 'cuda':
        result['device'] = {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': cell.chips,
            'memory_peak_bytes': int(run.memory_peak_bytes)}
        result['card'] = timing.card_label(dev.index or 0)
        if trace:
            tr = run.ctx.trace
            result['device']['busy_s'] = tr.busy_s
            result['device']['window_s'] = tr.window_s
            result['breakdown'] = {'device_ops': tr.top_ops(10),
                                   'idle_gaps': tr.idle_gaps(10)}
    result['setup'] = phases.seconds
    result['checks'] = run.checks
    print(phases.line(), file=sys.stderr)
    for line in getattr(run, 'notes', []):
        print(line, file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_paths()
    import cells
    cell = cells.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     'cuda:0')
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
