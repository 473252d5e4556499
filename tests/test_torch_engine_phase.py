"""chip_smoke.py's engine phase (`run_engine`, phase 6) at the small
size on the CPU (tests/torch_parity.py::small_configs: ResNet-50 at
64×64, narrow heads, batch 2; a synthetic URSO dir of 8 train, 4 val
and 4 test frames at 96×72), where every kernel runs its plain version.

Tolerances: resume, the served batch against the plain version and the
artifact served again exactly (run_engine itself raises on any
difference).
"""

import numpy as np
import torch

import chip_smoke
# run_dir is a fixture
from torch_parity import run_dir, small_configs  # noqa: F401

torch.set_num_threads(1)


def test_chip_smoke_engine_phase_on_cpu(run_dir):
    """chip_smoke.py's engine phase (a)-(g) at the small size on the CPU:
    resident epochs, exact resume, a streamed epoch, the served batch
    equal to the plain version exactly, finite ESA, the artifact served
    again bit for bit."""
    _, cfg = small_configs()
    out = chip_smoke.run_engine(chip_smoke.engine_config(cfg), 'cpu',
                                str(run_dir), frames={'train': 8, 'val': 4,
                                                       'test': 4},
                                wh=(96, 72))
    assert len(out['resident_imgs_per_s']) == 2
    assert out['streaming_imgs_per_s'] > 0
    assert out['max_abs_err'] == 0.0
    assert np.isfinite(out['scores']['esa']).all()
