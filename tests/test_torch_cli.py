"""The port's command line (`python -m ursonet_torch.pose_estimator`)
against the repository's `pose_estimator.py`: the same parser (flags,
destinations, defaults, types), the same Config from the same flags, and
the README's quick start run through `main(..., device='cpu')` on a
synthetic URSO dataset (ResNet-50 at --image_scale 0.1, bottleneck 8,
branch 16, 6³ orientation bins).

Tolerances: parsers and Configs equal; the summary of `evaluate
--weights <exported .h5>` equal, digit for digit, to that of `--weights
last` (the same f32 weights through the port's HDF5 writer and reader).
"""

import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import pose_estimator as jcli
from ursonet_torch import pose_estimator as tcli
from ursonet_torch.checkpoint import hdf5
from ursonet_torch.data import loader as tloader
from ursonet_torch.data.png import decode_png
from ursonet_torch.data.synthetic import make_urso_dataset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Knobs of the JAX package's Config the port's does not carry: the Pallas
# warp switch (the port's warp is always its CUDA kernel) and the
# decoupled-orientation switch.
JAX_ONLY = {'DECOUPLE_ORIENTATION', 'PALLAS_WARP'}

FLAGSHIP = ['--bottleneck', '128', '--ori_resolution', '24',
            '--classify_ori', '--regress_loc', '--rot_aug',
            '--rot_image_aug', '--image_scale', '0.5']


def _actions(parser):
    return [(tuple(a.option_strings), a.dest, a.default, a.type, a.nargs,
             a.const, a.required, a.choices, type(a).__name__)
            for a in parser._actions]


def test_parser_matches_jax():
    assert _actions(tcli.build_parser()) == _actions(jcli.build_parser())
    for name in ('DEFAULT_LOGS_DIR', 'DEFAULT_DATA_DIR',
                 'DEFAULT_MODELS_DIR', 'ORIENTATION_PARAM_OPTIONS',
                 'RELEASED_MODELS'):
        assert getattr(tcli, name) == getattr(jcli, name), name


def _value(v):
    return v.tolist() if isinstance(v, np.ndarray) else v


@pytest.mark.parametrize('argv', [
    # the quick start's
    ['train', '--dataset', 'soyuz_easy', '--weights', 'coco',
     '--image_scale', '0.5', '--ori_resolution', '24', '--rot_aug',
     '--rot_image_aug', '--batch_size', '4'],
    ['evaluate', '--dataset', 'soyuz_easy', '--weights', 'last',
     '--image_scale', '0.5', '--ori_resolution', '24', '--int8',
     '--eval_batch', '8'],
    # the flagship's
    ['train', '--dataset', 'soyuz_hard', '--weights', 'none',
     '--branch_size', '1024', '--batch_size', '32', '--steps_per_epoch',
     '4', '--epochs', '1'] + FLAGSHIP,
    ['evaluate', '--dataset', 'soyuz_hard', '--weights', 'last', '--int8',
     '--f16', '--set', 'QUANT_STEM_S2D=True', '--set',
     'QUANT_HOST_S2D=True'] + FLAGSHIP,
    # --set overrides, the keypoint head, regression, square frames
    ['train', '--dataset', 'dragon', '--weights', 'none', '--set',
     'REMAT=narrow', '--set', 'LOSS_WEIGHTS={"loc_loss": 2.0}', '--set',
     'DATA_ON_DEVICE=False', '--regress_keypoints', '--f16',
     '--keep_checkpoints', '3', '--seed', '4', '--image_scale', '0.25'],
    ['test', '--dataset', 'x', '--weights', 'none', '--regress_ori',
     '--ori_param', 'euler_angles', '--square_image', '--image_scale', '0.1',
     '--classify_loc', '--loc_weight', '0.5', '--int8_float_finals'],
    # SPEED's frame size
    ['export', '--dataset', 'speed', '--weights', 'none', '--image_scale',
     '0.5', '--backbone', 'resnet101'],
    # int8 training activations, alone and under REMAT
    ['train', '--dataset', 'x', '--weights', 'none', '--set',
     'TRAIN_ACT_Q8=True', '--set', 'REMAT=narrow'],
    ['train', '--dataset', 'x', '--weights', 'none', '--set',
     'TRAIN_ACT_Q8=wgrad8', '--f16'],
])
def test_make_config_matches_jax(argv, monkeypatch):
    import jax
    monkeypatch.setattr(jax, 'devices', lambda *a: jax.local_devices()[:1])
    want = jcli.make_config(jcli.build_parser().parse_args(argv))
    got = tcli.make_config(tcli.build_parser().parse_args(argv))
    jkeys = {k for k in dir(want) if k.isupper()}
    tkeys = {k for k in dir(got) if k.isupper()}
    assert jkeys - tkeys == JAX_ONLY
    for k in sorted(jkeys & tkeys):
        assert _value(getattr(got, k)) == _value(getattr(want, k)), k


@pytest.mark.parametrize('argv', [
    ['train', '--dataset', 'x', '--weights', 'none', '--ori_param', 'rpy'],
    ['train', '--dataset', 'x', '--weights', 'none', '--image_scale', '0.33'],
    ['train', '--dataset', 'x', '--weights', 'none', '--set', 'NOPE=1'],
    ['train', '--dataset', 'x', '--weights', 'none', '--set', 'REMAT'],
    ['train', '--dataset', 'x', '--weights', 'none', '--set', 'update=1'],
])
def test_make_config_refuses_what_jax_refuses(argv, monkeypatch):
    import jax
    monkeypatch.setattr(jax, 'devices', lambda *a: jax.local_devices()[:1])
    with pytest.raises(SystemExit) as want:
        jcli.make_config(jcli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        tcli.make_config(tcli.build_parser().parse_args(argv))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    make_urso_dataset(str(root / 'datasets' / 'tiny'),
                      n_per_subset={'train': 4, 'val': 2, 'test': 5},
                      width=128, height=96, seed=1)
    yield {'data': str(root / 'datasets'), 'logs': str(root / 'logs'),
           'out': str(root / 'out'), 'models': str(root / 'models')}
    shutil.rmtree(root, ignore_errors=True)


def _args(env, command, *extra):
    return ([command, '--dataset', 'tiny', '--data_dir', env['data'],
             '--logs', env['logs'], '--out_dir', env['out'],
             '--models_dir', env['models'], '--backbone', 'resnet50',
             '--bottleneck', '8', '--branch_size', '16', '--image_scale',
             '0.1', '--ori_resolution', '6', '--classify_ori',
             '--regress_loc', '--rot_aug', '--rot_image_aug']
            + list(extra))


def _summary(out: str) -> list:
    return [line for line in out.splitlines()
            if line.startswith(('Mean est.', 'ESA score', 'Mean encoded'))]


def test_quick_start_on_the_cpu(env, capsys):
    rc = tcli.main(_args(env, 'train', '--weights', 'none', '--epochs', '1',
                         '--steps_per_epoch', '2', '--batch_size', '2',
                         '--set', 'VALIDATION_STEPS=1'), device='cpu')
    assert rc == 0
    runs = glob.glob(os.path.join(env['logs'], 'tiny*'))
    assert len(runs) == 1
    assert glob.glob(os.path.join(runs[0], 'weights_tiny_0000.msgpack'))
    assert os.path.exists(os.path.join(runs[0], 'state_latest.msgpack'))
    capsys.readouterr()

    assert tcli.main(_args(env, 'evaluate', '--weights', 'last',
                           '--eval_batch', '2'), device='cpu') == 0
    last = _summary(capsys.readouterr().out)
    assert len(last) == 4 and last[2].startswith('ESA score')
    for name in ('ori_err.csv', 'loc_err.csv', 'dists_err.csv'):
        with open(os.path.join(env['out'], name)) as f:
            lines = f.read().splitlines()
        assert lines[0] == ',0' and len(lines) == 6

    # int8 serving; bias_correct's 57 capture passes are left to export
    # below (each costs the CPU seconds at this size)
    assert tcli.main(_args(env, 'evaluate', '--weights', 'last', '--int8',
                           '--eval_batch', '2', '--bias_correct', '0',
                           '--multimodal'), device='cpu') == 0
    out = capsys.readouterr().out
    assert 'int8: calibrated on 2 fixed images' in out
    assert 'SmoothQuant migration applied' in out
    assert 'bias correction applied' not in out
    assert 'Multimodal best-of-2-modes orientation error' in out
    assert len(_summary(out)) == 4

    assert tcli.main(_args(env, 'test', '--weights', 'last',
                           '--eval_batch', '2'), device='cpu') == 0
    overlays = sorted(glob.glob(os.path.join(env['out'], 'overlays',
                                             '*.png')))
    assert len(overlays) == 5           # min(10, the 5 test frames)
    with open(overlays[0], 'rb') as f:
        assert decode_png(f.read()).shape == (96, 128, 3)
    frame = os.path.join(env['data'], 'tiny', '0_rgb.png')
    assert tcli.main(_args(env, 'test', '--weights', 'last', '--image',
                           frame), device='cpu') == 0
    assert 'quaternion (scalar-last)' in capsys.readouterr().out
    assert os.path.exists(os.path.join(env['out'], 'single_image_pose.png'))

    assert tcli.main(_args(env, 'export', '--weights', 'last', '--int8'),
                     device='cpu') == 0
    out = capsys.readouterr().out
    assert 'bias correction applied (1 pass(es))' in out
    h5 = os.path.join(env['out'], 'tiny_weights.h5')
    assert os.path.exists(os.path.join(env['out'], 'tiny_int8.msgpack'))
    names = [n.decode() for n in hdf5.File(h5).attrs['layer_names']]
    assert 'conv1' in names and 'ori_final' in names

    assert tcli.main(_args(env, 'evaluate', '--weights', h5,
                           '--eval_batch', '2'), device='cpu') == 0
    out = capsys.readouterr().out
    assert 'h5 import: ' in out and '0 shape-mismatched' in out
    assert _summary(out) == last


@pytest.mark.parametrize('extra,item', [
    (['test', '--weights', 'none', '--video', 'v.mp4'], 'video'),
])
def test_what_is_not_ported_raises(env, extra, item, tmp_path):
    """test --video reads Motion-JPEG AVI only: an mp4 clip (what the JAX
    package writes through cv2) raises, naming the file."""
    clip = tmp_path / extra[-1]
    clip.write_bytes(b'\0\0\0\x18ftypmp42' + bytes(16))
    with pytest.raises(ValueError, match='not an AVI') as e:
        tcli.main(_args(env, *extra[:-1], str(clip)), device='cpu')
    assert str(clip) in str(e.value) and item == 'video'


@pytest.mark.parametrize('extra,mesh', [
    (['train', '--weights', 'none', '--mesh_data', '2'], (2, 1)),
    (['evaluate', '--weights', 'none', '--mesh_model', '2'], (2, 2)),
])
def test_mesh_flags_make_the_mesh(env, extra, mesh, monkeypatch):
    """--mesh_data / --mesh_model (refused before the parallel slice)
    make the JAX CLI's mesh knobs (a 4-rank world, --mesh_data 0 taking
    world // mesh_model); a process without a 2-rank world refuses the
    mesh, naming the launcher (tests/test_torch_multihost.py trains
    through the CLI on a 2 x 2 mesh)."""
    import jax
    import torch.distributed as dist
    argv = _args(env, *extra)
    monkeypatch.setattr(jax, 'devices',
                        lambda *a: jax.local_devices()[:1] * 4)
    want = jcli.make_config(jcli.build_parser().parse_args(argv))
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda *a: 4)
    got = tcli.make_config(tcli.build_parser().parse_args(argv))
    monkeypatch.undo()
    for k in ('MESH_DATA', 'MESH_MODEL', 'GPU_COUNT', 'BATCH_SIZE'):
        assert getattr(got, k) == getattr(want, k), k
    assert (got.MESH_DATA, got.MESH_MODEL) == mesh
    with pytest.raises(RuntimeError, match='torch.distributed.run'):
        tcli.main(argv, device='cpu')


def test_host_augment_trains(env, tmp_path, monkeypatch, capsys):
    """`train --host_augment` (it raised before the host-parity generator
    was ported): the host-parity generator feeds the steps, no device
    preprocess is made, the losses are finite."""
    def no_preprocess(*a, **k):
        raise AssertionError('a device preprocess under --host_augment')
    monkeypatch.setattr(tloader, 'make_device_preprocess', no_preprocess)
    loads = []
    real = tloader.load_image_gt
    monkeypatch.setattr(tloader, 'load_image_gt',
                        lambda *a: loads.append(a[2]) or real(*a))
    logs = str(tmp_path / 'logs')
    rc = tcli.main(_args(env, 'train', '--weights', 'none', '--host_augment',
                         '--epochs', '1', '--steps_per_epoch', '2',
                         '--batch_size', '2', '--logs', logs, '--set',
                         'VALIDATION_STEPS=1'), device='cpu')
    assert rc == 0
    assert len(loads) >= 6          # 2 train steps + 1 validation step
    runs = glob.glob(os.path.join(logs, 'tiny*'))
    with open(os.path.join(runs[0], 'metrics.jsonl')) as f:
        record = json.loads(f.read().splitlines()[-1])
    assert np.isfinite(record['loss']) and np.isfinite(record['val_loss'])
    capsys.readouterr()


def test_speed_dataset_raises(env):
    """--dataset speed loads SPEED's subsets (it raised before the SPEED
    adapter was ported): the labelled ones with PMFs, the unlabelled
    ones with the bin map only; `submit` without --dataset speed exits
    as the JAX CLI does."""
    from ursonet_torch.data.speed import Speed
    from ursonet_torch.data.synthetic import make_speed_dataset
    make_speed_dataset(os.path.join(env['data'], 'speed'), n_per_subset=2,
                       width=64, height=40)
    args = tcli.build_parser().parse_args(
        ['evaluate', '--dataset', 'speed', '--weights', 'none',
         '--data_dir', env['data'], '--ori_resolution', '6'])
    cfg = tcli.make_config(args)
    val, test = tcli.load_datasets(args, cfg, ('val', 'test'))
    assert isinstance(val, Speed) and isinstance(test, Speed)
    assert len(val.image_ids) == len(test.image_ids) == 2
    assert len(val.image_info[0]['ori_map']) == 6 ** 3
    assert 'quaternion' not in test.image_info[0]
    with pytest.raises(SystemExit, match='--dataset speed'):
        tcli.main(_args(env, 'submit', '--weights', 'none'), device='cpu')


def test_the_card_or_nothing(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tcli.main(_args(env, 'evaluate', '--weights', 'none'))
    # the module entry point fails at once on a machine without a card
    r = subprocess.run(
        [sys.executable, '-m', 'ursonet_torch.pose_estimator', 'evaluate',
         '--dataset', 'tiny', '--weights', 'none', '--data_dir',
         env['data']], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert r.returncode != 0 and 'CUDA is not available' in r.stderr
    assert 'ESA score' not in r.stdout
