"""Shared set-up of the benchmark's tests: the harness's folder on the
import path, and cells cut to a size the CPU runs in seconds."""

from __future__ import annotations

import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
REPO = PORTBENCH.parent
for _p in (str(REPO), str(PORTBENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import cells  # noqa: E402
import run  # noqa: E402

SERVE = 'urso_r50_flagship.serve_int8_b128'
SERVE_KP = 'urso_r101_keypoints.serve_int8_b128'
TRAIN = 'urso_r50_flagship.train_f16_b32'
SEED = 2 ** 31 + 4321


def tiny_serve(name: str = SERVE, root: Path = PORTBENCH):
    """The serve cell at 64x128 images, batches of 4, two in the pool."""
    cell = cells.load_cell(name, root)
    cell.config['config'].update(IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=128)
    cell.traffic.update(batch=4, pool_batches=2, calib_images=4,
                        check_batches=2, warmup_batches=1)
    return cell


def tiny_train(f16: bool = False):
    """The train cell at 192x256 frames, batches of 2, 8 frames. The f32
    model by default: the CPU's bf16 convolutions accumulate otherwise
    than the card's, so the card's limits hold the card's runs only."""
    cell = cells.load_cell(TRAIN)
    cell.config['config'].update(IMAGE_MIN_DIM=192, IMAGE_MAX_DIM=256,
                                 F16=f16)
    cell.traffic.update(batch=2, frames=8, warmup_steps=1)
    return cell


def measure_cpu(cell, seconds: float = 0.5, **hooks) -> dict:
    run.setup_paths()
    return run.measure(cell, SEED, seconds, False, 'cpu',
                       t0=time.perf_counter(), **hooks)
