"""The engine under TRAIN_BN=None: the port's `UrsoNet` and the JAX
package's trained side by side (ResNet-18, 64×64, batch 2) on a
synthetic URSO dir of 8 frames a subset at 96×72, with the running
statistics training; states resumed across the packages; a resumed
port run against an uninterrupted one; DEBUG_NANS on a NaN batch.

Tolerances:
  * both engines from the same weights on the same streamed batches
    (ROT_AUG off): per-epoch losses within 1e-3 relative, parameters
    within ENGINE_UNITS in update units, batch_stats within ENGINE_STATS
    relative. The synthetic frames are black but for one small object,
    so most activations are near-constant, where the fast variance
    E[x²] − E[x]² cancels in f32: JAX normalizes with it, the port with
    F.batch_norm's two-pass statistics, and both keep it for the running
    update, where the two packages' sums give `bn_conv0` variances 3.9e-5
    apart (measured 9.0e-3 update units, 3.7e-5 over batch_stats; the
    first step's losses agree to 1.2e-7). On random batches of 2 the
    steps agree at 1e-3 and 1e-5 (tests/test_torch_train_bn.py; ROADMAP
    §3);
  * a state written by either package resumes in the other bit for bit
    (params, batch_stats with the trained running statistics, velocity,
    step, epoch);
  * the port resumed after epoch 1 and trained to epoch 2 equals the
    uninterrupted 2-epoch run bit for bit, running statistics included
    (resident data, whose permutation is keyed by the epoch).
"""

import shutil

import numpy as np
import pytest
import torch

from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_tpu.engine import UrsoNet as JaxUrsoNet
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.data import loader as tloader
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.engine import UrsoNet
from test_torch_engine_parity import _load, _np_tree, _trees_equal
from test_torch_train import _flat, _rel
from torch_parity import small_configs

torch.set_num_threads(1)

QUIET = dict(log_fn=lambda *a: None)
ENGINE_UNITS = 2e-2     # parameters, in update units (measured 9.0e-3)
ENGINE_STATS = 1e-4     # batch_stats, relative L2 (measured 3.7e-5)


def _configs(**kw):
    return small_configs(BACKBONE='resnet18', TRAIN_BN=None, ROT_AUG=False,
                         STEPS_PER_EPOCH=2, VALIDATION_STEPS=1, **kw)


@pytest.fixture(scope='module')
def urso_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso_bn'))
    make_urso_dataset(d, n_per_subset=8, width=96, height=72)
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope='module')
def runs(urso_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp('engines_bn')
    jcfg, tcfg = _configs(DATA_ON_DEVICE=False, NATIVE_LOADER=False)
    out = {}
    jeng = JaxUrsoNet('training', jcfg, str(root / 'jax'))
    jeng.initialize()
    w0 = str(root / 'w0.msgpack')
    jeng.save_weights(w0)
    out['w0'] = {'params': _np_tree(jeng.state.params),
                 'batch_stats': _np_tree(jeng.state.batch_stats)}
    out['jax_means'] = jeng.train(
        _load(JaxUrso, urso_dir, jcfg, 'train'),
        _load(JaxUrso, urso_dir, jcfg, 'val'), jcfg.LEARNING_RATE, 1,
        **QUIET)
    out['jax'] = {'params': _np_tree(jeng.state.params),
                  'batch_stats': _np_tree(jeng.state.batch_stats),
                  'velocity': _np_tree(jeng.state.opt_state[1].velocity),
                  'step': int(jeng.state.step), 'log_dir': jeng.log_dir}
    teng = UrsoNet('training', tcfg, str(root / 'port'), device='cpu')
    teng.load_weights(w0)
    out['port_means'] = teng.train(
        _load(Urso, urso_dir, tcfg, 'train'),
        _load(Urso, urso_dir, tcfg, 'val'), tcfg.LEARNING_RATE, 1, **QUIET)
    out['port'] = {**params_to_jax_layout(teng.model.state_dict()),
                   'velocity': _velocity(teng), 'step': teng.step,
                   'log_dir': teng.log_dir}
    assert jeng.resume_state(out['port']['log_dir'])
    out['jax_resumed'] = {
        'params': _np_tree(jeng.state.params),
        'batch_stats': _np_tree(jeng.state.batch_stats),
        'velocity': _np_tree(jeng.state.opt_state[1].velocity),
        'step': int(jeng.state.step)}
    teng2 = UrsoNet('training', tcfg, str(root / 'port2'), device='cpu')
    assert teng2.resume_state(out['jax']['log_dir'])
    out['port_resumed'] = {**params_to_jax_layout(teng2.model.state_dict()),
                           'velocity': _velocity(teng2),
                           'step': teng2.step}
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _velocity(engine):
    from ursonet_torch.checkpoint import store
    return store.velocity_tree(engine.model, engine.velocity)


def test_engine_trains_statistics_as_jax(runs):
    for k, v in runs['jax_means'].items():
        assert _rel(runs['port_means'][k], v) <= 1e-3, k
    _, wj = _flat(runs['jax']['params'])
    _, wt = _flat(runs['port']['params'])
    _, w0 = _flat(runs['w0']['params'])
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0) <= ENGINE_UNITS
    _, sj = _flat(runs['jax']['batch_stats'])
    _, st = _flat(runs['port']['batch_stats'])
    _, s0 = _flat(runs['w0']['batch_stats'])
    assert np.linalg.norm(st - sj) <= ENGINE_STATS * np.linalg.norm(sj)
    assert np.linalg.norm(sj - s0) > 1e-3 * np.linalg.norm(s0)
    assert runs['port']['step'] == runs['jax']['step'] == 2


@pytest.mark.parametrize('side,source', [('jax_resumed', 'port'),
                                         ('port_resumed', 'jax')])
def test_trained_statistics_resume_across_packages(runs, side, source):
    got, want = runs[side], runs[source]
    for key in ('params', 'batch_stats', 'velocity'):
        _trees_equal(got[key], want[key], key)
    assert got['step'] == want['step']


def test_resume_continues_bit_for_bit(urso_dir, tmp_path):
    _, tcfg = _configs(DATA_ON_DEVICE=True)
    train_ds = _load(Urso, urso_dir, tcfg, 'train')
    val_ds = _load(Urso, urso_dir, tcfg, 'val')
    whole = UrsoNet('training', tcfg, str(tmp_path / 'whole'), device='cpu')
    whole.train(train_ds, val_ds, None, epochs=2, **QUIET)
    first = UrsoNet('training', tcfg, str(tmp_path / 'first'), device='cpu')
    first.train(train_ds, val_ds, None, epochs=1, **QUIET)
    resumed = UrsoNet('training', tcfg, str(tmp_path / 'res'), device='cpu')
    assert resumed.resume_state(first.log_dir)
    resumed.train(train_ds, val_ds, None, epochs=2, **QUIET)
    want = whole.model.state_dict()
    got = resumed.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    moved = first.model.state_dict()
    assert not torch.equal(want['backbone.bn_conv0.running_mean'],
                           moved['backbone.bn_conv0.running_mean'])
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize('debug_nans', [False, True])
def test_debug_nans_raises_on_a_nan_batch(urso_dir, tmp_path, monkeypatch,
                                          debug_nans):
    """A NaN in the second batch's images: DEBUG_NANS raises
    FloatingPointError naming the step; without it the epoch ends with
    NaN losses, as in the JAX package."""
    _, tcfg = _configs(AUGMENT_ON_DEVICE=False, DEBUG_NANS=debug_nans)
    real = tloader._load_parity
    seen = []

    def poisoned(*a):
        sample = real(*a)
        seen.append(a[2])
        if len(seen) == 3:
            sample['images'][5, 7, 1] = np.nan
        return sample
    monkeypatch.setattr(tloader, '_load_parity', poisoned)
    engine = UrsoNet('training', tcfg, str(tmp_path), device='cpu')
    train_ds = _load(Urso, urso_dir, tcfg, 'train')
    if debug_nans:
        with pytest.raises(FloatingPointError, match='train step 1'):
            engine.train(train_ds, None, None, epochs=1, **QUIET)
    else:
        means = engine.train(train_ds, None, None, epochs=1, **QUIET)
        assert np.isnan(means['loss'])
    shutil.rmtree(tmp_path, ignore_errors=True)
