"""chip_smoke.py's batch-statistics BN and host-parity phase
(`run_trainbn`, phase 8c) at a small size on the CPU, where every kernel
runs its plain version: the flagship recipe under TRAIN_BN=None in f32
and F16, config 5's running statistics with and without REMAT, config 2
under TRAIN_BN=True at batch 1, the TRAIN_BN=None model served int8,
the command line's `train --host_augment`, and DEBUG_NANS on a NaN
batch.

Tolerances: run_trainbn raises on any difference it checks (REMAT's
running statistics and the served heads against the plain version:
exact; losses finite and falling; no warp under --host_augment).
"""

import torch

import chip_smoke
from ursonet_torch.data.synthetic import make_urso_dataset
from test_torch_config2_phase import _small as small_config2
# run_dir is a fixture
from torch_parity import run_dir  # noqa: F401

torch.set_num_threads(2)

SMALL_FLAGS = ['--backbone', 'resnet18', '--bottleneck', '16',
               '--branch_size', '32', '--ori_resolution', '6',
               '--classify_ori', '--regress_loc', '--rot_aug',
               '--rot_image_aug', '--image_scale', '0.1']


def _flagship(f16):
    cfg = chip_smoke.small_config(3)
    cfg.BACKBONE = 'resnet18'
    cfg.F16 = f16
    cfg.update()
    return cfg


def test_chip_smoke_trainbn_phase_on_cpu(run_dir):
    root = str(run_dir)
    make_urso_dataset(root + '/urso',
                      n_per_subset={'train': 4, 'val': 2, 'test': 2},
                      width=256, height=192, seed=0)
    cfg5 = chip_smoke.small_config(5)
    cfg5.BACKBONE = 'resnet50'
    cfg5.update()
    out = chip_smoke.run_trainbn(root, 'cpu', 0, cfg_fn=_flagship,
                                 cfg5=cfg5, cfg2=small_config2('resnet18'),
                                 flags=SMALL_FLAGS, train_batch=2,
                                 host_steps=2)
    assert out['host_loader_ips'] > 0 and out['host_step_ips'] > 0
    assert out['host_epoch_ips'] > 0
    assert out['f32']['estimate_gb'] > 0
    assert set(out['rows']) >= {'gemm_s8_f32acc', 'conv_s8_f32acc'}
