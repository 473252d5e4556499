"""Batch-statistics batch norm (TRAIN_BN None and True) in the port
against the JAX package: one layer against `FrozenAwareBN` (Flax's
`nn.BatchNorm` with mutable batch_stats), the train and validation
steps. ResNet-18 at 64×64, batch 2 (4 under F16), the same
weights (the port's initialization with random BN, in both packages) on
the same batches.

Tolerances:
  * one BN: output relative L2 1e-5 (bf16 input and output: 1e-2), the
    gradients of a weighted sum 1e-5; running mean and variance after
    one update 1e-6 relative; at one value per channel (a head BN at
    batch 1) the output equal to Flax's and finite;
  * train steps: losses 1e-3 relative, the update 1e-3 in update units
    (‖w_port − w_jax‖ / ‖w_jax − w_0‖), the validation losses 1e-3, the
    whole of batch_stats after two steps 1e-5 relative (each leaf 1e-4);
    under F16 the bf16 step's bounds (tests/test_torch_bf16_train.py). The f32
    JAX steps run op by op (jit=False): under TRAIN_BN=True the head BN
    over a batch of 2 leaves the update ill-conditioned, and JAX's own
    jitted and op-by-op steps differ by 6.3e-3 update units there, while
    the port agrees with the op-by-op one to 1.0e-4 (measured);
    (REMAT, int8 PTQ and DEBUG_NANS under TRAIN_BN: test_torch_train_bn_remat.py)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ursonet_tpu.models.resnet import FrozenAwareBN
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_eval_step as jax_make_eval_step
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models.resnet import FrozenBN
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, make_train_step
from test_torch_bf16_train import LOSS_REL, PARAM_REL, TREE_REL
from test_torch_keypoints import kp_batch, port_variables
from test_torch_train import _batch, _flat, _torch_batch
from torch_parity import rel_l2, small_configs

torch.set_num_threads(1)

STATS_REL = 1e-5        # the whole of batch_stats after two steps
STATS_LEAF_REL = 1e-4   # each leaf


# --------------------------------------------------------------------------
# one layer


def _bn_pair(train_bn, c, rng, f16):
    """Flax's FrozenAwareBN and the port's FrozenBN with the same random
    affine parameters and running statistics."""
    params = {'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
              'bias': (rng.randn(c) * 0.1).astype(np.float32)}
    stats = {'mean': (rng.randn(c) * 0.1).astype(np.float32),
             'var': rng.uniform(0.5, 1.5, c).astype(np.float32)}
    jmod = FrozenAwareBN(train_bn, jnp.bfloat16 if f16 else jnp.float32)
    variables = {'params': {'bn': params}, 'batch_stats': {'bn': stats}}
    bn = FrozenBN(c, train_bn)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params['scale']))
        bn.bias.copy_(torch.from_numpy(params['bias']))
        bn.running_mean.copy_(torch.from_numpy(stats['mean']))
        bn.running_var.copy_(torch.from_numpy(stats['var']))
    return jmod, variables, bn


def _nchw(a):
    a = np.asarray(a, np.float32)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('train_bn', [False, None, True])
def test_bn_matches_flax(train_bn, training, f16):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 5, 6, 8) * 3 + 1.5).astype(np.float32)   # NHWC
    jmod, variables, bn = _bn_pair(train_bn, 8, rng, f16)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if f16 else \
        (jnp.float32, torch.float32)
    xj = jnp.asarray(x).astype(jdt)
    y, mutated = jmod.apply(variables, xj, training=training,
                            mutable=['batch_stats'])
    xt = torch.from_numpy(_nchw(np.asarray(xj.astype(jnp.float32)))).to(tdt)
    xt.requires_grad_(True)
    bn.train(training)
    yt = bn(xt)
    assert yt.dtype == tdt
    assert rel_l2(yt.detach().float().numpy(), _nchw(y)) <= \
        (1e-2 if f16 else 1e-5)
    updates = train_bn is not False and training
    assert (bn.pending is not None) == updates
    assert bn.commit() == updates
    new = mutated['batch_stats']['bn']
    np.testing.assert_allclose(bn.running_mean.numpy(), new['mean'],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), new['var'],
                               rtol=1e-6, atol=0)
    if not updates:
        np.testing.assert_array_equal(
            bn.running_var.numpy(), variables['batch_stats']['bn']['var'])
    if f16:
        return
    # the backward through the batch statistics against flax's vjp
    g = rng.randn(*x.shape).astype(np.float32)

    def f(xx, p):
        return jmod.apply({'params': {'bn': p},
                           'batch_stats': variables['batch_stats']}, xx,
                          training=training, mutable=['batch_stats'])[0]
    _, vjp = jax.vjp(f, jnp.asarray(x), variables['params']['bn'])
    gx, gp = vjp(jnp.asarray(g))
    (yt * torch.from_numpy(_nchw(g))).sum().backward()
    assert rel_l2(xt.grad.numpy(), _nchw(gx)) <= 1e-5
    assert rel_l2(bn.weight.grad.numpy(), gp['scale']) <= 1e-5
    assert rel_l2(bn.bias.grad.numpy(), gp['bias']) <= 1e-5


@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('train_bn', [None, True])
def test_bn_one_value_per_channel(train_bn, f16):
    """A head BN at batch 1: F.batch_norm refuses one value per channel;
    Flax gives var = 0 and the bias as the output."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 16).astype(np.float32) * 4
    jmod, variables, bn = _bn_pair(train_bn, 16, rng, f16)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if f16 else \
        (jnp.float32, torch.float32)
    y, mutated = jmod.apply(variables, jnp.asarray(x).astype(jdt),
                            training=True, mutable=['batch_stats'])
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    bn.train()
    yt = bn(xt)
    assert yt.dtype == tdt and torch.isfinite(yt.float()).all()
    np.testing.assert_array_equal(yt.detach().float().numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    yt.float().sum().backward()
    assert torch.isfinite(xt.grad.float()).all()
    assert bn.commit()
    new = mutated['batch_stats']['bn']
    np.testing.assert_allclose(bn.running_mean.numpy(), new['mean'],
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new['var'],
                               rtol=1e-6)


# --------------------------------------------------------------------------
# the train and validation steps


def _configs(train_bn, heads='pose', **kw):
    if heads == 'keypoints':
        kw['REGRESS_KEYPOINTS'] = True
    return small_configs(BACKBONE=kw.pop('BACKBONE', 'resnet18'),
                         TRAIN_BN=train_bn, **kw)


def _stats_rel(a, b):
    """(relative L2 over the whole tree, largest relative L2 of a leaf)."""
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    _, fa = _flat(a)
    _, fb = _flat(b)
    return (np.linalg.norm(fa - fb) / np.linalg.norm(fb),
            max(rel_l2(x, y) for x, y in zip(la, lb)))


def _lockstep(jcfg, tcfg, batch, layers="all", steps=2, jit=False):
    """`steps` train steps of both packages from the port's seeded
    weights (random BN), then a validation step."""
    tree = port_variables(tcfg, seed=2)
    jmodel = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        jmodel, jcfg, tx, trainable=jstate.trainable_mask(state.params,
                                                          layers), jit=jit)
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    tstep = make_train_step(model, tcfg, make_optimizer(tcfg),
                            trainable=trainable_mask(model, layers),
                            device='cpu')
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {'tree': tree, 'jm': [], 'tm': []}
    for _ in range(steps):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(0))
        out['jm'].append({k: float(v) for k, v in jm.items()})
        out['tm'].append({k: float(v) for k, v in tstep(
            _torch_batch(batch)).items()})
    out['jv'] = {k: float(v) for k, v in jax_make_eval_step(
        jmodel, jcfg, jit=jit)(state, jbatch, jax.random.PRNGKey(1)).items()}
    out['tv'] = {k: float(v) for k, v in make_eval_step(
        model, tcfg, device='cpu')(_torch_batch(batch)).items()}
    out['jax'] = {'params': jax.tree_util.tree_map(np.asarray, state.params),
                  'batch_stats': jax.tree_util.tree_map(
                      np.asarray, state.batch_stats)}
    out['port'] = params_to_jax_layout(model.state_dict())
    out['model'] = model
    return out


def _check_metrics(got, want, rel):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= rel * abs(v), (k, got[k], v)


@pytest.mark.parametrize('heads', ['pose', 'keypoints'])
@pytest.mark.parametrize('train_bn', [None, True])
def test_train_and_val_steps_match_jax(train_bn, heads):
    jcfg, tcfg = _configs(train_bn, heads)
    assert tcfg.NR_DENSE_LAYERS >= 1
    batch = kp_batch(3) if heads == 'keypoints' else _batch(jcfg, seed=3)
    out = _lockstep(jcfg, tcfg, batch)
    head_bn = {'loc_bn_0'} | ({'ori_bn_0'} if heads == 'pose' else set())
    got_bn = {k for h in ('loc_head', 'ori_head')
              for k in out['port']['batch_stats'].get(h, {})}
    assert got_bn == (head_bn if train_bn else set())
    for tm, jm in zip(out['tm'], out['jm']):
        _check_metrics(tm, jm, 1e-3)
    _check_metrics(out['tv'], out['jv'], 1e-3)
    names_j, wj = _flat(out['jax']['params'])
    names_t, wt = _flat(out['port']['params'])
    assert names_j == names_t
    _, w0 = _flat(out['tree']['params'])
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0) <= 1e-3
    whole, leaf = _stats_rel(out['port']['batch_stats'],
                             out['jax']['batch_stats'])
    assert whole <= STATS_REL and leaf <= STATS_LEAF_REL, (whole, leaf)
    # the statistics moved: 0.99² of the old ones after two updates
    _, s0 = _flat(out['tree']['batch_stats'])
    _, s2 = _flat(out['port']['batch_stats'])
    assert np.linalg.norm(s2 - s0) > 1e-3 * np.linalg.norm(s0)


def test_frozen_layers_update_their_statistics():
    """layers='heads' freezes the backbone's parameters, not its running
    statistics: the JAX step makes all of batch_stats mutable."""
    jcfg, tcfg = _configs(None)
    out = _lockstep(jcfg, tcfg, _batch(jcfg, seed=4), layers='heads',
                    steps=1)
    tree = out['tree']
    bb = 'bn_conv0'
    np.testing.assert_array_equal(
        out['port']['params']['backbone'][bb]['bn']['scale'],
        tree['params']['backbone'][bb]['bn']['scale'])
    assert not np.array_equal(
        out['port']['batch_stats']['backbone'][bb]['bn']['mean'],
        tree['batch_stats']['backbone'][bb]['bn']['mean'])
    whole, leaf = _stats_rel(out['port']['batch_stats'],
                             out['jax']['batch_stats'])
    assert whole <= STATS_REL and leaf <= STATS_LEAF_REL, (whole, leaf)
    _check_metrics(out['tm'][0], out['jm'][0], 1e-3)


# Under TRAIN_BN=True these biases feed a batch norm, which takes out
# any constant they add: their true gradient is 0, so their update is
# rounding noise in both packages (measured 1.12-1.19 apart relative to
# the JAX update, beside <= 0.38 for every other parameter at batch 4).
FEEDS_BN = ("['bottleneck_layer']['bias']",
            "['loc_head']['loc_dense_0']['bias']",
            "['ori_head']['ori_dense_0']['bias']")


@pytest.mark.parametrize('train_bn', [None, True])
def test_f16_train_step_matches_jax(train_bn):
    """The F16 step (bf16 forward, f32 statistics, parameters and update)
    against the JAX package's jitted F16 step, at the bounds of
    tests/test_torch_bf16_train.py, at batch 4 (at batch 2 a head BN's
    output is ±1 up to epsilon, and the hidden denses before it get
    almost no gradient); the parameters of FEEDS_BN have none, and their
    updates are held to rounding level instead."""
    jcfg, tcfg = _configs(train_bn, F16=True, IMAGES_PER_GPU=4)
    out = _lockstep(jcfg, tcfg, _batch(jcfg, seed=5), steps=1, jit=True)
    _check_metrics(out['tm'][0], out['jm'][0], LOSS_REL)
    names, ft = _flat(out['port']['params'])
    _, fj = _flat(out['jax']['params'])
    _, f0 = _flat(out['tree']['params'])
    tree_update = np.linalg.norm(fj - f0)
    assert np.linalg.norm(ft - fj) <= TREE_REL * tree_update
    w0 = jax.tree_util.tree_leaves_with_path(out['tree']['params'])
    wj = jax.tree_util.tree_leaves(out['jax']['params'])
    wt = jax.tree_util.tree_leaves(out['port']['params'])
    for (path, c), a, b in zip(w0, wt, wj):
        du, dj = np.float64(a) - c, np.float64(b) - c
        if train_bn and jax.tree_util.keystr(path) in FEEDS_BN:
            assert max(np.linalg.norm(du), np.linalg.norm(dj)) \
                <= 1e-3 * tree_update
            continue
        assert np.linalg.norm(du - dj) <= PARAM_REL * np.linalg.norm(dj)
    whole, _ = _stats_rel(out['port']['batch_stats'],
                          out['jax']['batch_stats'])
    assert whole <= LOSS_REL, whole
    assert all(p.dtype == torch.float32 for p in out['model'].parameters())
    assert all(b.dtype == torch.float32 for b in out['model'].buffers())
