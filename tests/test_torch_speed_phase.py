"""chip_smoke.py's SPEED phase (`run_speed`, phase 8) at a small size on
the CPU, where every kernel runs its plain version: the engine's config
4 recipe (tests/torch_parity.py::small_configs with sim2real, CLR and
rotations: ResNet-50 at 128x192, narrow heads, batch 2) in each sim2real
order on synthetic SPEED frames at 160x100, then the command line's
train, evaluate and submit (float and --int8) at --image_scale 0.1, and
an Adam + CLR resume.

Tolerances: run_speed raises on any difference: every learning rate
within 1e-6 relative of the float64 cyclical schedule, the channels of
the first preprocessed train batch within 1e-3 of each other, the gray
warp's recorded call equal to the plain version, the int8 submit's raw
heads equal to the plain version's, the resumed Adam state exactly.
"""

import numpy as np
import torch

import chip_smoke
# run_dir is a fixture
from torch_parity import run_dir, small_configs  # noqa: F401

torch.set_num_threads(2)

SMALL_FLAGS = ['--backbone', 'resnet50', '--bottleneck', '8',
               '--branch_size', '16', '--ori_resolution', '6',
               '--classify_ori', '--regress_loc', '--image_scale', '0.1',
               '--sim2real', '--clr', '--rot_aug', '--rot_image_aug']


def _small(order, optimizer):
    _, cfg = small_configs(mode='pad64', dim=192, IMAGE_MIN_DIM=128,
                           IMAGE_MAX_DIM=192, ROT_AUG=True,
                           ROT_IMAGE_AUG=True)
    return chip_smoke.speed_config(cfg, order, optimizer)


def test_chip_smoke_speed_phase_on_cpu(run_dir):
    out = chip_smoke.run_speed(
        str(run_dir), 'cpu', cfg_fn=_small,
        frames={'train_no_val': 4, 'val': 2, 'test': 3, 'real_test': 2},
        wh=(160, 100), cli_flags=SMALL_FLAGS, train_batch=2, eval_batch=2,
        steps=2)
    assert set(out['seconds']) == {
        'frames', 'engine per_image_order=False',
        'engine per_image_order=True', 'cli train', 'cli evaluate',
        'cli submit', 'cli submit int8', 'adam'}
    assert np.isfinite(out['evaluate']['esa_score'])
    assert out['decode_ms'] > 0 and out['encode_ms'] > 0
    assert out['max_abs_err'] == 0.0
    # on the CPU the wrappers run the plain versions: no launches
    assert sum(out['rows'].values()) == 0


def test_speed_config_is_benchmark_config_4():
    cfg = chip_smoke.speed_config()
    assert (cfg.BACKBONE, cfg.BOTTLENECK_WIDTH, cfg.ORI_BINS_PER_DIM) == \
        ('resnet50', 128, 16)
    assert tuple(cfg.IMAGE_SHAPE[:2]) == chip_smoke.SPEED_TRAIN_SHAPE[1:]
    assert cfg.BATCH_SIZE == chip_smoke.SPEED_TRAIN_SHAPE[0]
    assert cfg.SIM2REAL_AUG and cfg.CLR and not cfg.REGRESS_ORI
    # up for 3 updates, down for 3
    got = [chip_smoke.clr_numpy(c, 1e-4, 5e-4, 3) for c in range(7)]
    want = [1e-4 + 4e-4 * k / 3 for k in (0, 1, 2, 3, 2, 1, 0)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
