"""The port's engine and the JAX package's side by side
(`ursonet_torch/engine.py::UrsoNet` against `ursonet_tpu/engine.py::
UrsoNet`), at the small size (tests/torch_parity.py::small_configs) on a
synthetic URSO dir of 8 frames a subset at 96×72.

Tolerances:
  * weights and train states cross both ways exactly: params,
    batch_stats, velocity, step and epoch;
  * both engines trained from the same weights on the same batches (the
    same RandomState shuffle; ROT_AUG and DATA_ON_DEVICE off), 2 epochs
    of 3 steps and 1 validation step: per-epoch losses within TRAJ_REL =
    1e-3 relative, final params within 1e-3 in update units
    (‖w_port − w_jax‖ / ‖w_jax − w_0‖, tests/test_torch_train.py's bound).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from ursonet_tpu.checkpoint import store as jstore
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
EPOCHS = 2
ENGINE_KW = dict(STEPS_PER_EPOCH=3, VALIDATION_STEPS=1)


@pytest.fixture(scope='module')
def urso_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso'))
    make_urso_dataset(d, n_per_subset=8, width=96, height=72)
    return d


def _load(cls, d, cfg, subset):
    ds = cls()
    ds.load_dataset(d, cfg, subset)
    return ds


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _trees_equal(a, b, path=''):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f'{path}/{k}')
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


# --------------------------------------------------------------------------
# the two engines side by side


@pytest.fixture(scope='module')
def runs(urso_dir, tmp_path_factory):
    """Both engines trained EPOCHS epochs from the JAX engine's initial
    weights on the streaming path, then each resumed from the other's
    run dir and each loading the other's last snapshot. Everything as
    numpy in the JAX layout."""
    root = tmp_path_factory.mktemp('engines')
    jcfg, tcfg = small_configs(ROT_AUG=False, DATA_ON_DEVICE=False,
                               NATIVE_LOADER=False, **ENGINE_KW)
    out = {}
    jeng = JaxUrsoNet('training', jcfg, str(root / 'jax'))
    jeng.initialize()
    w0 = str(root / 'w0.msgpack')
    jeng.save_weights(w0)
    out['w0'] = _np_tree(jeng.state.params)
    out['jax_means'] = jeng.train(
        _load(JaxUrso, urso_dir, jcfg, 'train'),
        _load(JaxUrso, urso_dir, jcfg, 'val'), jcfg.LEARNING_RATE, EPOCHS,
        log_fn=lambda *a: None)
    out['jax'] = {'params': _np_tree(jeng.state.params),
                  'batch_stats': _np_tree(jeng.state.batch_stats),
                  'velocity': _np_tree(jeng.state.opt_state[1].velocity),
                  'step': int(jeng.state.step), 'epoch': jeng.epoch,
                  'log_dir': jeng.log_dir}

    teng = UrsoNet('training', tcfg, str(root / 'port'), device='cpu')
    teng.load_weights(w0)
    assert teng.epoch == 0
    out['port_means'] = teng.train(
        _load(Urso, urso_dir, tcfg, 'train'),
        _load(Urso, urso_dir, tcfg, 'val'), tcfg.LEARNING_RATE, EPOCHS,
        log_fn=lambda *a: None)
    out['port'] = {**params_to_jax_layout(teng.model.state_dict()),
                   'velocity': store.velocity_tree(teng.model,
                                                   teng.velocity),
                   'step': teng.step, 'epoch': teng.epoch,
                   'log_dir': teng.log_dir}
    for side in ('jax', 'port'):
        with open(os.path.join(out[side]['log_dir'], 'metrics.jsonl')) as f:
            out[side]['records'] = [json.loads(line) for line in f]

    # the JAX engine resumes the port's run and loads its snapshot
    assert jeng.resume_state(out['port']['log_dir'])
    out['jax_resumed'] = {
        'params': _np_tree(jeng.state.params),
        'batch_stats': _np_tree(jeng.state.batch_stats),
        'velocity': _np_tree(jeng.state.opt_state[1].velocity),
        'step': int(jeng.state.step), 'epoch': jeng.epoch}
    jeng.load_weights(store.find_last(str(root / 'port')))
    out['jax_loaded'] = {'params': _np_tree(jeng.state.params),
                         'batch_stats': _np_tree(jeng.state.batch_stats),
                         'epoch': jeng.epoch}
    # the port resumes the JAX engine's run and loads its snapshot
    teng2 = UrsoNet('training', tcfg, str(root / 'port2'), device='cpu')
    assert teng2.resume_state(out['jax']['log_dir'])
    out['port_resumed'] = {
        **params_to_jax_layout(teng2.model.state_dict()),
        'velocity': store.velocity_tree(teng2.model, teng2.velocity),
        'step': teng2.step, 'epoch': teng2.epoch}
    teng2.load_weights(jstore.find_last(str(root / 'jax')))
    out['port_loaded'] = {**params_to_jax_layout(teng2.model.state_dict()),
                          'epoch': teng2.epoch}
    return out


def test_engine_trajectory_matches_jax(runs):
    jr, tr = runs['jax']['records'], runs['port']['records']
    assert [r['epoch'] for r in tr] == [r['epoch'] for r in jr] == [0, 1]
    for a, b in zip(tr, jr):
        for k in ('loss', 'val_loss', 'loc_loss', 'ori_loss'):
            assert _rel(a[k], b[k]) <= TRAJ_REL, (a['epoch'], k, a[k], b[k])
    for k in runs['jax_means']:
        assert _rel(runs['port_means'][k], runs['jax_means'][k]) <= TRAJ_REL
    names_j, wj = _flat(runs['jax']['params'])
    names_t, wt = _flat(runs['port']['params'])
    assert names_j == names_t
    _, w0 = _flat(runs['w0'])
    units = np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0)
    assert units <= 1e-3, units
    assert runs['port']['step'] == runs['jax']['step'] == 6
    assert runs['port']['epoch'] == runs['jax']['epoch'] == EPOCHS


@pytest.mark.parametrize('side,source', [('jax_resumed', 'port'),
                                         ('port_resumed', 'jax')])
def test_state_resumes_across_packages(runs, side, source):
    got, want = runs[side], runs[source]
    for key in ('params', 'batch_stats', 'velocity'):
        _trees_equal(got[key], want[key], key)
    assert (got['step'], got['epoch']) == (want['step'], EPOCHS)
    assert np.abs(_flat(want['velocity'])[1]).max() > 0


@pytest.mark.parametrize('side,source', [('jax_loaded', 'port'),
                                         ('port_loaded', 'jax')])
def test_weights_load_across_packages(runs, side, source):
    """The other package's last snapshot, by name: the same weights, and
    the epoch after the snapshot's."""
    got, want = runs[side], runs[source]
    _trees_equal(got['params'], want['params'], 'params')
    _trees_equal(got['batch_stats'], want['batch_stats'], 'batch_stats')
    assert got['epoch'] == EPOCHS


def test_summary_matches_jax(runs, tmp_path):
    """Parameter counts per top-level module, as the JAX engine's tree
    holds them; the Kendall log-variances add one a loss part."""
    want = {top: sum(int(np.prod(np.shape(x)))
                     for x in jax.tree_util.tree_leaves(sub))
            for top, sub in runs['w0'].items()}
    for learnable in (False, True):
        _, tcfg = small_configs(LEARNABLE_LOSS_WEIGHTS=learnable)
        got = UrsoNet('training', tcfg, str(tmp_path), device='cpu').summary(
            log_fn=lambda *a: None)
        extra = {'loss_log_vars': 2} if learnable else {}
        assert got['per_module'] == {**want, **extra}
        assert got['total'] == sum(want.values()) + len(extra) * 2
