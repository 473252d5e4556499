"""chip_smoke.py's Orbax phase (`run_orbax`, phase 8e) at a small size on
the CPU, where every kernel runs its plain version: one epoch under
CHECKPOINT_FORMAT='orbax', a fresh engine's resume and next epoch, the
snapshot served int8, and the committed JAX-written fixture; and the
command line under `--set CHECKPOINT_FORMAT=orbax`.

Tolerances: run_orbax raises on any difference it checks (the resumed
state, the next epoch against the uninterrupted engine's, the loaded
weights, the served heads against the plain version, the fixture's
arrays: all exact).
"""

import glob
import os

import torch

import chip_smoke
from ursonet_torch import pose_estimator as tcli
from ursonet_torch.data.synthetic import make_urso_dataset
# run_dir is a fixture
from torch_parity import run_dir  # noqa: F401

torch.set_num_threads(2)


def _small():
    return chip_smoke.engine_config(chip_smoke.small_config(3))


def test_chip_smoke_orbax_phase_on_cpu(run_dir):
    root = str(run_dir)
    make_urso_dataset(root + '/urso', subsets=('train',), n_per_subset=4,
                      width=96, height=72, seed=0)
    out = chip_smoke.run_orbax(root, 'cpu', 0, cfg_fn=_small, calib=2)
    assert out['state_bytes'] > out['weights_bytes'] > 0
    assert out['write_s'] > 0 and out['read_s'] > 0
    assert out['fixture_mb_s'] > 0 and out['state_mb_s'] > 0
    assert set(out['rows']) >= {'gemm_s8_f32acc', 'conv_s8_f32acc'}


def _cli(root, command, *extra):
    return ([command, '--dataset', 'tiny', '--data_dir', root + '/datasets',
             '--logs', root + '/logs', '--out_dir', root + '/out',
             '--models_dir', root + '/models', '--backbone', 'resnet18',
             '--bottleneck', '8', '--branch_size', '16', '--image_scale',
             '0.1', '--ori_resolution', '6', '--classify_ori',
             '--regress_loc', '--set', 'CHECKPOINT_FORMAT=orbax']
            + list(extra))


def test_cli_under_orbax_on_the_cpu(run_dir, capsys):
    """`--set CHECKPOINT_FORMAT=orbax`: train writes snapshot and state
    directories, `--weights last` and `--weights <dir>.orbax` serve the
    same weights in evaluate, test and export, and a second train
    continues the run from its last snapshot."""
    root = str(run_dir)
    make_urso_dataset(root + '/datasets/tiny',
                      n_per_subset={'train': 4, 'val': 2, 'test': 2},
                      width=128, height=96, seed=1)
    train = ('--epochs', '1', '--steps_per_epoch', '2', '--batch_size', '2',
             '--set', 'VALIDATION_STEPS=1')
    assert tcli.main(_cli(root, 'train', '--weights', 'none', *train),
                     device='cpu') == 0
    runs = glob.glob(root + '/logs/tiny*')
    assert len(runs) == 1
    snap = os.path.join(runs[0], 'weights_tiny_0000.orbax')
    assert os.path.isdir(snap)
    assert os.path.isdir(os.path.join(runs[0], 'state_latest.orbax'))
    assert not glob.glob(runs[0] + '/*.msgpack')
    capsys.readouterr()
    summaries = []
    for weights in ('last', snap):
        assert tcli.main(_cli(root, 'evaluate', '--weights', weights,
                              '--eval_batch', '2'), device='cpu') == 0
        summaries.append([line for line in capsys.readouterr().out
                          .splitlines() if line.startswith('ESA score')])
    assert summaries[0] == summaries[1] and len(summaries[0]) == 1
    frame = root + '/datasets/tiny/0_rgb.png'
    assert tcli.main(_cli(root, 'test', '--weights', 'last', '--image',
                          frame), device='cpu') == 0
    assert tcli.main(_cli(root, 'export', '--weights', snap),
                     device='cpu') == 0
    assert os.path.exists(root + '/out/tiny_weights.h5')
    assert tcli.main(_cli(root, 'train', '--weights', 'last', *train[:1],
                          '2', *train[2:]), device='cpu') == 0
    assert os.path.isdir(os.path.join(runs[0], 'weights_tiny_0001.orbax'))
