"""The port's losses, L2 term, layer mask and train step against the JAX
package's, from the same weights on the same molded batch (preprocess
None on both sides; the JAX step runs without jit).

Tolerances: losses, L2 and step metrics within 1e-5 relative; updated
parameters within 1e-3 in update units, ‖w_port − w_jax‖ / ‖Δw_jax‖ over
the whole parameter tree after one and after two steps (f32 gradients
summed in another order, then clipped and applied through momentum).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.ops import encoders as jenc
from ursonet_tpu.train import losses as jlosses
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train import losses as tlosses
from ursonet_torch.train.optim import KerasSGD, make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, make_train_step
from test_torch_model import jax_variables
from torch_parity import small_configs, unit_quats

torch.set_num_threads(1)


def _batch(jcfg, seed=0):
    rng = np.random.RandomState(seed)
    b = jcfg.BATCH_SIZE
    h, w = int(jcfg.IMAGE_SHAPE[0]), int(jcfg.IMAGE_SHAPE[1])
    grid = jenc.build_ori_grid(jcfg.ORI_BINS_PER_DIM)
    q = unit_quats(rng, b)
    return {
        'images': (rng.randn(b, h, w, 3) * 50).astype(np.float32),
        'gt_loc': np.stack([rng.uniform(-3, 3, b), rng.uniform(-3, 3, b),
                            rng.uniform(5, 40, b)], 1).astype(np.float32),
        'gt_ori': jenc.encode_ori_pmf(q, grid.quat, grid.mask, jcfg.BETA,
                                      jcfg.ORI_BINS_PER_DIM).astype(
                                          np.float32),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out['images'] = torch.from_numpy(
        batch['images'].transpose(0, 3, 1, 2).copy())
    return out


def _flat(params):
    leaves = jax.tree_util.tree_leaves_with_path(params)
    return [jax.tree_util.keystr(p) for p, _ in leaves], \
        np.concatenate([np.ravel(np.asarray(v, np.float64))
                        for _, v in leaves])


def _rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.fixture(scope='module')
def jax_init():
    """(JAX model, its initialized variables as numpy) at the small size."""
    jcfg, _ = small_configs()
    jmodel = jax_build_model(jcfg)
    return jmodel, jax_variables(jmodel, (2, 64, 64, 3))


@pytest.fixture(scope='module')
def lockstep(jax_init):
    """Two train steps on both sides from one set of weights."""
    jcfg, tcfg = small_configs()
    jmodel, tree = jax_init
    batch = _batch(jcfg)

    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        jmodel, jcfg, tx, trainable=jstate.trainable_mask(state.params, 'all'),
        jit=False)
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    tstep = make_train_step(model, tcfg, make_optimizer(tcfg),
                            trainable=trainable_mask(model, 'all'),
                            device='cpu')
    out = {'w0': tree['params'], 'steps': []}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(0))
        tm = tstep(_torch_batch(batch))
        out['steps'].append({
            'jax_params': jax.tree_util.tree_map(np.asarray, state.params),
            'jax_metrics': {k: float(v) for k, v in jm.items()},
            'torch_params': params_to_jax_layout(model.state_dict())['params'],
            'torch_metrics': {k: float(v) for k, v in tm.items()},
        })
    return out


@pytest.mark.parametrize('n_steps', [1, 2])
def test_train_steps_match_jax(lockstep, n_steps):
    s = lockstep['steps'][n_steps - 1]
    names_j, wj = _flat(s['jax_params'])
    names_t, wt = _flat(s['torch_params'])
    assert names_j == names_t
    _, w0 = _flat(lockstep['w0'])
    update_units = np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0)
    assert update_units <= 1e-3, update_units
    assert set(s['torch_metrics']) == set(s['jax_metrics'])
    for k, v in s['jax_metrics'].items():
        assert _rel(s['torch_metrics'][k], v) <= 1e-5, k


@pytest.mark.parametrize('regress_loc,regress_ori', [
    (True, False), (False, True), (False, False)])
def test_compute_losses_match_jax(regress_loc, regress_ori):
    jcfg, tcfg = small_configs(REGRESS_LOC=regress_loc, LOC_BINS_PER_DIM=4,
                               REGRESS_ORI=regress_ori)
    rng = np.random.RandomState(4)
    batch = _batch(jcfg, seed=4)
    outs = {'loc': rng.randn(2, 3).astype(np.float32) * 5,
            'ori': np.maximum(rng.randn(2, 216), 0).astype(np.float32) * 3}
    if not regress_loc:
        outs['loc'] = np.maximum(rng.randn(2, 64), 0).astype(np.float32)
        pmf = rng.rand(2, 64)
        batch['gt_loc'] = (pmf / pmf.sum(1, keepdims=True)).astype(np.float32)
    if regress_ori:
        outs['ori'] = unit_quats(rng, 2)
        batch['gt_ori'] = unit_quats(rng, 2)
    jt, jp = jlosses.compute_losses(
        {k: jnp.asarray(v) for k, v in outs.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tt, tp = tlosses.compute_losses(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        _torch_batch(batch), tcfg)
    assert set(tp) == set(jp)
    assert _rel(tt, jt) <= 1e-5
    for k in jp:
        assert _rel(tp[k], jp[k]) <= 1e-5, k


def test_l2_regularization_matches_jax(jax_init):
    _, tcfg = small_configs()
    _, tree = jax_init
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    jmask = jstate.trainable_mask(tree['params'], '4+')
    tmask = trainable_mask(model, '4+')
    for wd in (1e-4, 0.3):
        for jm, tm in ((None, None), (jmask, tmask)):
            ref = jlosses.l2_regularization(tree['params'], wd, jm)
            got = tlosses.l2_regularization(model, wd, tm)
            assert _rel(got, ref) <= 1e-5


def test_trainable_mask_matches_jax(jax_init):
    _, tcfg = small_configs()
    _, tree = jax_init
    model = build_model(tcfg, device='cpu')
    for layers in ('heads', '3+', '5+', 'all'):
        jmask = jstate.trainable_mask(tree['params'], layers)
        as_sd = params_from_jax({'params': jax.tree_util.tree_map(
            lambda m, p: np.full(p.shape, m, np.float32), jmask,
            tree['params'])})
        tmask = trainable_mask(model, layers)
        assert set(as_sd) == set(tmask)
        for name, flag in tmask.items():
            assert bool(as_sd[name].reshape(-1)[0]) == flag, name
    heads = trainable_mask(model, 'heads')
    assert heads['bottleneck_layer.weight'] and \
        heads['ori_head.ori_final.weight']
    assert not heads['backbone.res5c.res5c_branch2c.weight']
    assert not heads['backbone.bn_conv1.weight']


def test_frozen_layers_do_not_move():
    _, tcfg = small_configs()
    model = build_model(tcfg, device='cpu')
    mask = trainable_mask(model, 'heads')
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, tcfg, make_optimizer(tcfg), trainable=mask,
                           device='cpu')
    jcfg, _ = small_configs()
    metrics = step(_torch_batch(_batch(jcfg, seed=7)))
    assert np.isfinite(float(metrics['loss']))
    after = model.state_dict()
    for name, flag in mask.items():
        assert torch.equal(before[name], after[name]) != flag, name
    val = make_eval_step(model, tcfg, device='cpu')(
        _torch_batch(_batch(jcfg, seed=7)))
    assert set(val) == {'loc_loss', 'ori_loss', 'loss'}


def test_keras_sgd_update_and_clip():
    """v ← m·v − lr·g; w ← w + v, after clipping the global norm."""
    p = [torch.tensor([1.0, 2.0]), torch.tensor([3.0])]
    opt = KerasSGD(0.1, momentum=0.9, clip_norm=5.0)
    opt.step(p, [torch.tensor([3.0, 0.0]), torch.tensor([4.0])])  # norm 5
    torch.testing.assert_close(p[0], torch.tensor([0.7, 2.0]))
    torch.testing.assert_close(p[1], torch.tensor([2.6]))
    opt.step(p, [torch.tensor([30.0, 0.0]), torch.tensor([40.0])])  # → 3, 4
    # v = 0.9·(-0.3, 0, -0.4) − 0.1·(3, 0, 4)
    torch.testing.assert_close(p[0], torch.tensor([0.7 - 0.57, 2.0]))
    torch.testing.assert_close(p[1], torch.tensor([2.6 - 0.76]))
