"""chip_smoke.py's benchmark config 2 phase (`run_config2`, phase 8b) at a
small size on the CPU, where every kernel runs its plain version: the
command line at ResNet-18's flags (train streamed through the native
loader, evaluate in float, --int8 and --int8 --f16 with the s2d knobs,
export, evaluate the h5, test), a ResNet-18 step with the memory
estimate, a ResNet-34 step and an int8 served batch.

Tolerances: run_config2 raises on any difference (the native batches
against load_batch_plain, the served raw heads against the plain
version, the h5's heads against --weights last: all exact); the flags
give benchmark_config(2)'s Config, knob for knob, but for streaming
from disk.
"""

import numpy as np
import torch

import chip_smoke
from ursonet_torch import pose_estimator, presets
from ursonet_torch.data.synthetic import make_urso_dataset
# run_dir is a fixture
from torch_parity import run_dir  # noqa: F401

torch.set_num_threads(2)

SMALL_FLAGS = ['--backbone', 'resnet18', '--bottleneck', '16',
               '--branch_size', '32', '--regress_loc', '--regress_ori',
               '--ori_param', 'quaternion', '--rot_aug', '--image_scale',
               '0.1', '--set', 'DATA_ON_DEVICE=False', '--set',
               'VALIDATION_STEPS=1']


def _small(backbone):
    cfg = chip_smoke.config2(backbone)
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
    cfg.BRANCH_SIZE = 32
    cfg.BOTTLENECK_WIDTH = 16
    cfg.update()
    return cfg


def test_config2_flags_make_benchmark_config_2():
    args = pose_estimator.build_parser().parse_args(
        ['train', '--dataset', 'soyuz_easy', '--weights', 'none',
         '--batch_size', '1'] + chip_smoke.CONFIG2_FLAGS)
    got, want = pose_estimator.make_config(args), presets.benchmark_config(2)
    differ = set()
    for k in (k for k in dir(want) if k.isupper()):
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(a, np.ndarray):
            a, b = a.tolist(), b.tolist()
        if a != b:
            differ.add(k)
    assert differ == {'DATA_ON_DEVICE'} and got.DATA_ON_DEVICE is False
    assert chip_smoke.config2('resnet34').BACKBONE == 'resnet34'


def test_chip_smoke_config2_phase_on_cpu(run_dir):
    root = str(run_dir)
    make_urso_dataset(root + '/urso',
                      n_per_subset={'train': 4, 'val': 2, 'test': 3},
                      width=256, height=192, seed=0)
    out = chip_smoke.run_config2(root, 'cpu', 0, flags=SMALL_FLAGS, steps=2,
                                 cfg_fn=_small)
    cli = out['cli']
    assert set(cli['imgs_per_s']) == {'evaluate', 'evaluate int8',
                                      'evaluate int8 s2d f16'}
    assert all(v > 0 for v in cli['imgs_per_s'].values())
    assert out['estimate_gb'] > 0
