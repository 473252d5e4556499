"""Several ranks, each its own rows: the port's `parallel/multihost.py`,
`Config.update()`'s mesh knobs and `data_generator(batch_slice=...)`
against the JAX package's, and the engine and the CLI trained by a 2 x 2
gloo world of four processes (`torch_parallel_worker.py`, which imports
no JAX) against one process.

Tolerances: the slices, the config fields and the generator's rows
exactly (byte for byte); the world's initial weights bit for bit (every
rank builds the whole model from the seed and keeps its shards); its
epoch means within 1e-5 relative and its weights rtol 2e-4 / atol 2e-5
(the JAX package's DP x TP test, tests/test_parallel.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from ursonet_tpu.config import Config as JaxConfig
from ursonet_tpu.data import loader as jloader
from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_tpu.parallel import multihost as jmh
from ursonet_torch.config import Config
from ursonet_torch.data import loader as tloader
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.engine import UrsoNet
from ursonet_torch.parallel import multihost
from ursonet_torch.parallel.mesh import Mesh
from test_torch_parallel import join, spawn
import torch_parallel_worker as W

torch.set_num_threads(1)


@pytest.mark.parametrize('knobs', [
    dict(MESH_DATA=4, MESH_MODEL=2, IMAGES_PER_GPU=2),
    dict(MESH_DATA=1, MESH_MODEL=1, GPU_COUNT=3, IMAGES_PER_GPU=2),
    dict(MESH_DATA=1, MESH_MODEL=4, IMAGES_PER_GPU=5),
    dict(MESH_DATA=2, MESH_MODEL=1, GPU_COUNT=7, IMAGES_PER_GPU=1),
])
def test_config_update_mesh_knobs_match_jax(knobs):
    got, want = Config(), JaxConfig()
    for cfg in (got, want):
        for k, v in knobs.items():
            setattr(cfg, k, v)
        cfg.update()
    for k in ('MESH_DATA', 'MESH_MODEL', 'GPU_COUNT', 'BATCH_SIZE'):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize('bslice', [None, (2, 5), np.array([0, 3, 4])])
def test_slice_rows_matches_jax(bslice):
    np.testing.assert_array_equal(multihost.slice_rows(bslice, 6),
                                  jmh.slice_rows(bslice, 6))


@pytest.mark.parametrize('ranks,pid,want', [
    ([[0, 1], [2, 3]], 0, (0, 4)),
    ([[0, 1], [2, 3]], 3, (4, 8)),
    ([[0], [1], [2], [3]], 2, (4, 6)),
    # a process on two rows apart (a layout that interleaves processes)
    ([[0], [1], [0], [1]], 1, np.array([2, 3, 6, 7])),
])
def test_local_batch_slice(ranks, pid, want, monkeypatch):
    """The rows of a process, contiguous as (lo, hi), else an index
    array, as the JAX package's local_batch_slice gives them; a batch
    that does not divide over 'data' is refused."""
    grid = np.asarray(ranks)
    mesh = Mesh(*grid.shape)
    mesh.ranks = grid
    monkeypatch.setattr(multihost, 'process_index', lambda: pid)
    got = multihost.local_batch_slice(mesh, 8)
    if isinstance(want, tuple):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match='divisible'):
        multihost.local_batch_slice(mesh, 2 * grid.shape[0] + 1)


def test_local_batch_slice_of_one_process_matches_jax():
    from ursonet_tpu import parallel as jpar
    for data, model in ((8, 1), (4, 2)):
        want = jmh.local_batch_slice(jpar.make_mesh(data=data, model=model),
                                     16)
        assert multihost.local_batch_slice(Mesh(1, 1), 16) == want


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp('mh') / 'tiny'
    make_urso_dataset(str(d), subsets=('train', 'val'),
                      n_per_subset={'train': 8, 'val': 4}, width=96,
                      height=72, seed=3)
    return str(d)


@pytest.mark.parametrize('native', [True, False])
@pytest.mark.parametrize('bslice', [(0, 2), (2, 4), np.array([0, 3])])
def test_generator_batch_slice_matches_jax(frames, native, bslice):
    """A rank's rows of the raw global batches, on the native route and
    the Python path, are the JAX generator's rows byte for byte (three
    batches of 4 from 8 frames: across a reshuffle)."""
    cfgs = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.IMAGE_RESIZE_MODE = 'square'
        cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
        cfg.NATIVE_LOADER = native
        cfg.update()
        cfgs.append(cfg)
    jds, tds = JaxUrso(), Urso()
    jds.load_dataset(frames, cfgs[0], 'train')
    tds.load_dataset(frames, cfgs[1], 'train')
    jgen = jloader.data_generator(jds, cfgs[0], batch_size=4, seed=5,
                                  raw=True, batch_slice=bslice)
    tgen = tloader.data_generator(tds, cfgs[1], batch_size=4, seed=5,
                                  raw=True, batch_slice=bslice)
    full = tloader.data_generator(tds, cfgs[1], batch_size=4, seed=5,
                                  raw=True)
    rows = multihost.slice_rows(bslice, 4)
    for _ in range(3):
        want, got, whole = next(jgen), next(tgen), next(full)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], whole[k][rows], err_msg=k)


def test_generator_batch_slice_raises_at_the_first_bad_frame(frames):
    """With a batch slice a frame that fails raises at once: a skip would
    desynchronize the ranks' global stream."""
    cfg = Config()
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
    cfg.NATIVE_LOADER = False
    cfg.update()
    ds = Urso()
    ds.load_dataset(frames, cfg, 'train')
    ds.image_info = [dict(i, path=i['path'] + '.missing')
                     for i in ds.image_info]
    with pytest.raises(Exception):
        next(tloader.data_generator(ds, cfg, shuffle=False, batch_size=4,
                                    seed=0, raw=True, batch_slice=(0, 2)))


ENGINE_DATA = {'streamed': False, 'resident': True}


def _engine_config(mesh, per, resident):
    return W.tiny_config(REGRESS_ORI=False, ORI_BINS_PER_DIM=6, ROT_AUG=True,
                         ROT_IMAGE_AUG=True, IMAGES_PER_GPU=per,
                         MESH_DATA=mesh[0], MESH_MODEL=mesh[1],
                         STEPS_PER_EPOCH=2, VALIDATION_STEPS=1,
                         DATA_ON_DEVICE=resident, NATIVE_LOADER=False)


@pytest.fixture(scope='module')
def world(frames, tmp_path_factory):
    """The 2 x 2 world: UrsoNet.train streamed by per-rank generators,
    and the CLI's train command with --mesh_data 2 --mesh_model 2."""
    d = tmp_path_factory.mktemp('mhworld')
    torch.save({'configs': {k: _engine_config((2, 2), 2, r).to_dict()
                            for k, r in ENGINE_DATA.items()},
                'data': frames}, d / 'in_engine.pt')
    root = os.path.dirname(frames)
    torch.save({'argv': [
        'train', '--dataset', 'tiny', '--data_dir', root,
        '--logs', str(d / 'cli_logs'), '--weights', 'none',
        '--backbone', 'resnet18', '--bottleneck', '8', '--branch_size',
        '16', '--image_scale', '0.05', '--ori_resolution', '6',
        '--classify_ori', '--regress_loc', '--rot_aug', '--batch_size', '2',
        '--epochs', '1', '--steps_per_epoch', '2', '--set',
        'VALIDATION_STEPS=1', '--mesh_data', '2', '--mesh_model', '2']},
        d / 'in_cli.pt')
    procs = spawn(d, ('engine', 'cli'))
    one = {}
    try:
        for key, resident in ENGINE_DATA.items():
            cfg = _engine_config((1, 1), 4, resident)
            tr, va = Urso(), Urso()
            tr.load_dataset(frames, cfg, 'train')
            va.load_dataset(frames, cfg, 'val')
            eng = UrsoNet('training', cfg, str(d / f'one_{key}'),
                          device='cpu')
            init = {k: v.clone() for k, v in eng.initialize().state_dict()
                    .items()}
            means = eng.train(tr, va, cfg.LEARNING_RATE, epochs=1,
                              log_fn=lambda *a: None)
            one[key] = {'init': init, 'means': means,
                        'whole': eng.model.state_dict(),
                        'log_dir': eng.log_dir}
    finally:
        res = join(procs, d, ('engine', 'cli'))
    return d, res, one


@pytest.mark.parametrize('key', list(ENGINE_DATA))
def test_engine_trains_over_the_mesh_as_one_process(world, key):
    """Every rank starts from the single-process init, trains on its rows
    of the same global batches (per-rank generators, or its rows of the
    resident dataset's permuted batches), and ends with the
    single-process weights and epoch means; rank 0 alone writes, whole
    files that one process resumes."""
    d, res, one = world
    one = one[key]
    for r in range(4):
        got = res['engine'][r][key]
        assert got['means'].keys() == one['means'].keys()
        for k, v in one['means'].items():
            assert abs(got['means'][k] - v) <= 1e-5 * abs(v), k
    got = res['engine'][0][key]
    for k, v in one['init'].items():
        assert torch.equal(got['init'][k], v), k
    for k, v in one['whole'].items():
        np.testing.assert_allclose(got['whole'][k].numpy(), v.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    runs = os.listdir(d / f'logs_engine_{key}')
    assert len(runs) == 1 and os.path.join(
        d, f'logs_engine_{key}', runs[0]) == got['log_dir']
    names = sorted(os.listdir(got['log_dir']))
    assert names == sorted(os.listdir(one['log_dir']))
    with open(os.path.join(got['log_dir'], 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1 and records[0]['epoch'] == 0
    # the written state is whole: one process resumes it
    cfg = _engine_config((1, 1), 4, ENGINE_DATA[key])
    back = UrsoNet('training', cfg, str(d / 'resume'), device='cpu')
    assert back.resume_state(got['log_dir'])
    for k, v in back.model.state_dict().items():
        assert torch.equal(v, got['whole'][k]), k
    assert back.step == 2 and back.epoch == 1


def test_cli_trains_on_the_mesh(world):
    """`train --mesh_data 2 --mesh_model 2` (refused before the parallel
    slice) in a 4-rank world: exit 0, one run dir written by rank 0."""
    d, res, _ = world
    assert [res['cli'][r]['code'] for r in range(4)] == [0] * 4
    (run,) = os.listdir(d / 'cli_logs')
    names = os.listdir(d / 'cli_logs' / run)
    assert 'metrics.jsonl' in names and 'state_latest.msgpack' in names
    cfg = json.load(open(d / 'cli_logs' / run / 'config_0.json'))
    assert (cfg['MESH_DATA'], cfg['MESH_MODEL'], cfg['GPU_COUNT'],
            cfg['BATCH_SIZE']) == (2, 2, 4, 4)
