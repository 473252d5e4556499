"""The engines under CHECKPOINT_FORMAT='orbax': a run dir that one package
trained resumes and loads in the other (`ursonet_torch/engine.py` against
`ursonet_tpu/engine.py`), at the small size (tests/torch_parity.py::
small_configs) on a synthetic URSO dir of 8 frames a subset at 96x72.

Tolerances (tests/test_torch_engine_parity.py's):
  * weights and train states cross both ways exactly: params,
    batch_stats, velocity, step and epoch;
  * the next epoch (2 steps, the same batches) trained by both packages
    from the crossed state: losses within TRAJ_REL = 1e-3 relative,
    params within 1e-3 in update units (‖w_port − w_jax‖ / ‖w_jax −
    w_before‖).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_tpu.engine import UrsoNet as JaxUrsoNet
from ursonet_torch.checkpoint import store
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.engine import UrsoNet
from test_torch_train import _flat, _rel
from torch_parity import small_configs

torch.set_num_threads(1)

TRAJ_REL = 1e-3
ENGINE_KW = dict(ROT_AUG=False, DATA_ON_DEVICE=False, NATIVE_LOADER=False,
                 STEPS_PER_EPOCH=2, VALIDATION_STEPS=1,
                 CHECKPOINT_FORMAT='orbax')


def _load(cls, d, cfg, subset):
    ds = cls()
    ds.load_dataset(d, cfg, subset)
    return ds


def _jax_state(eng):
    s = jax.device_get(eng.state)
    return {'params': jax.tree_util.tree_map(np.asarray, s.params),
            'batch_stats': jax.tree_util.tree_map(np.asarray, s.batch_stats),
            'velocity': jax.tree_util.tree_map(np.asarray,
                                               s.opt_state[1].velocity),
            'step': int(s.step), 'epoch': eng.epoch}


def _port_state(eng):
    return {**params_to_jax_layout(eng.model.state_dict()),
            'velocity': store.velocity_tree(eng.model, eng.velocity),
            'step': eng.step, 'epoch': eng.epoch}


def _records(log_dir):
    with open(os.path.join(log_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """JAX -> port: the JAX engine trains epoch 0 under Orbax; the port
    takes that run (find_last, load_weights, resume_state), and both
    train epoch 1 from it. Port -> JAX: the port trains epochs 0-1 with
    CHECKPOINT_KEEP=1; the JAX engine resumes that run, and both train
    epoch 2 from it."""
    root = tmp_path_factory.mktemp('orbax_engines')
    data = str(root / 'urso')
    make_urso_dataset(data, n_per_subset=8, width=96, height=72)
    jcfg, tcfg = small_configs(**ENGINE_KW)
    _, tcfg_keep = small_configs(CHECKPOINT_KEEP=1, **ENGINE_KW)
    jds = _load(JaxUrso, data, jcfg, 'train')
    tds = _load(Urso, data, tcfg, 'train')
    quiet = dict(log_fn=lambda *a: None)
    out = {}

    jeng = JaxUrsoNet('training', jcfg, str(root / 'jax'))
    jeng.initialize()
    w0 = str(root / 'w0.msgpack')
    jeng.save_weights(w0)
    jeng.train(jds, None, jcfg.LEARNING_RATE, 1, **quiet)
    out['jax0'] = _jax_state(jeng)
    shutil.copytree(root / 'jax', root / 'jax_e0')
    jeng.train(jds, None, jcfg.LEARNING_RATE, 2, **quiet)
    out['jax1'] = _jax_state(jeng)
    out['jax1_records'] = _records(jeng.log_dir)

    teng = UrsoNet('training', tcfg, str(root / 'jax_e0'), device='cpu')
    out['found'] = teng.find_last()
    teng.load_weights(out['found'])
    out['port_loaded'] = {**params_to_jax_layout(teng.model.state_dict()),
                          'epoch': teng.epoch}
    assert teng.resume_state(os.path.dirname(out['found']))
    out['port_resumed'] = _port_state(teng)
    teng.train(tds, None, tcfg.LEARNING_RATE, 2, **quiet)
    out['port1'] = _port_state(teng)
    out['port1_records'] = _records(teng.log_dir)

    peng = UrsoNet('training', tcfg_keep, str(root / 'port'), device='cpu')
    peng.load_weights(w0)
    peng.train(tds, None, tcfg.LEARNING_RATE, 2, **quiet)
    out['port_run'] = sorted(os.listdir(peng.log_dir))
    out['port_e1'] = _port_state(peng)
    shutil.copytree(peng.log_dir, root / 'port_e1')
    assert jeng.resume_state(str(root / 'port_e1'))
    out['jax_resumed'] = _jax_state(jeng)
    jeng.train(jds, None, jcfg.LEARNING_RATE, 3, **quiet)
    out['jax2'] = _jax_state(jeng)
    out['jax2_records'] = _records(jeng.log_dir)
    peng.train(tds, None, tcfg.LEARNING_RATE, 3, **quiet)
    out['port2'] = _port_state(peng)
    out['port2_records'] = _records(peng.log_dir)
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _trees_equal(a, b, path=''):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f'{path}/{k}')
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize('side,source', [('port_resumed', 'jax0'),
                                         ('jax_resumed', 'port_e1')])
def test_orbax_state_resumes_across_packages(runs, side, source):
    got, want = runs[side], runs[source]
    for key in ('params', 'batch_stats', 'velocity'):
        _trees_equal(got[key], want[key], key)
    assert (got['step'], got['epoch']) == (want['step'], want['epoch'])
    assert np.abs(_flat(want['velocity'])[1]).max() > 0


def test_orbax_weights_load_in_the_port(runs):
    """find_last names the JAX run's snapshot directory; its weights load
    as they are, and the run goes on at the epoch after it."""
    assert runs['found'].endswith('weights_ursonet_0000.orbax')
    assert os.path.isdir(runs['found'])
    _trees_equal(runs['port_loaded']['params'], runs['jax0']['params'])
    _trees_equal(runs['port_loaded']['batch_stats'],
                 runs['jax0']['batch_stats'])
    assert runs['port_loaded']['epoch'] == 1


@pytest.mark.parametrize('port,jax_side,before,epoch',
                         [('port1', 'jax1', 'jax0', 1),
                          ('port2', 'jax2', 'port_e1', 2)])
def test_next_epoch_after_crossing(runs, port, jax_side, before, epoch):
    """The epoch each package trains from the crossed state agrees."""
    jr = [r for r in runs[f'{jax_side}_records'] if r['epoch'] == epoch]
    tr = [r for r in runs[f'{port}_records'] if r['epoch'] == epoch]
    assert len(jr) == len(tr) == 1
    for k in ('loss', 'loc_loss', 'ori_loss'):
        assert _rel(tr[0][k], jr[0][k]) <= TRAJ_REL, (k, tr[0][k], jr[0][k])
    _, wj = _flat(runs[jax_side]['params'])
    _, wt = _flat(runs[port]['params'])
    _, w0 = _flat(runs[before]['params'])
    units = np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0)
    assert units <= 1e-3, units
    assert runs[port]['step'] == runs[jax_side]['step'] == 2 * (epoch + 1)
    assert runs[port]['epoch'] == runs[jax_side]['epoch'] == epoch + 1


def test_port_prunes_snapshot_directories(runs):
    """CHECKPOINT_KEEP=1 removes the older snapshot directory; the state
    stays."""
    snaps = [n for n in runs['port_run'] if n.startswith('weights_')]
    assert snaps == ['weights_ursonet_0001.orbax']
    assert 'state_latest.orbax' in runs['port_run']
    assert not any(n.endswith('.msgpack') for n in runs['port_run'])
