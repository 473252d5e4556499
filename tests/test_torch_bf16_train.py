"""The port's bf16 training (F16), ResNet-101 and REMAT against the JAX
package, on the same inputs made with numpy from a seed, at 64×64,
BRANCH_SIZE 32, BOTTLENECK_WIDTH 16, batch 2. The weights are the
port's initialization with random batch-norm statistics, converted to
the JAX layout (`checkpoint/convert.py`).

Tolerances:
  * ResNet-101 (the keypoint model of config 5) in f32: each head within
    relative L2 1e-4 (the f32 bound of tests/test_torch_model.py). The
    JAX ResNet-101 is built once, here, and applied op by op.
  * REMAT: the port's gradients under True, 'narrow' and 'dots' equal
    its gradients without REMAT exactly, in f32 and in bf16 (the same
    ops recomputed on the CPU); 'narrow' never re-runs a 3×3 conv.
  * One bf16 residual block's forward and backward (the same
    cotangent) against JAX's op-by-op vjp of the flax block: the output
    equal but for 1% of its elements (the bound of the bf16 forward in
    tests/test_torch_f16.py; measured 0.3%), the input gradient within
    relative L2 1e-3 (measured 0: the same bits), the conv kernels' and
    the BN affine gradients within 5e-3 each (measured at most 7.4e-4),
    the conv biases' within 5e-2 (measured 1.7-2.6%: JAX's op-by-op
    bf16 reduce of the cotangent accumulates in bf16, the port's in f32
    and rounds once, within 0.2% of the float64 sum).
  * The F16 train step against the JAX package's jitted F16
    `make_train_step` at ResNet-50 depth, flagship and keypoint heads:
    each loss part and the total within 3e-2 relative (the heads bound
    of the bf16 forward in tests/test_torch_f16.py), the update over the
    whole tree within 0.35 of JAX's update (‖Δw_port − Δw_jax‖ /
    ‖Δw_jax‖), and each parameter's update within relative L2 0.85:
    under 1, so a parameter that JAX moves and the port leaves unmoved
    fails (‖0 − Δw_jax‖ = ‖Δw_jax‖).
    Measured on these inputs (keypoints, flagship): losses at most
    9.3e-3 and 2.4e-3 apart, the tree 0.070 and 0.081, single tensors
    up to 0.39 and 0.38. The bounds leave room for what one flipped
    ReLU does at this width: on another draw of the weights one hidden
    unit of the 32-wide `ori_dense_0` flips in bf16 and carries a large
    gradient, and the flagship's tree reads 0.238, one tensor 0.70, a
    keypoint loss 2.2e-2. For scale, the port's bf16 update is 0.073
    and 0.123 from its own f32 update, and the JAX package's jitted and
    op-by-op bf16 steps are 0.012 and 0.037 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu.models import resnet as jresnet
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models import resnet as tresnet
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_train_step
from test_torch_keypoints import _torch_batch, kp_batch, port_variables
from test_torch_model import _randomize_bn
from test_torch_train import _batch, _flat
from torch_parity import rel_l2, small_configs

torch.set_num_threads(1)

HEADS = ('loc', 'k1', 'k2')
LOSS_REL = 3e-2         # the heads bound of the bf16 forward
TREE_REL = 0.35         # the whole update, bf16 (see the docstring)
PARAM_REL = 0.85        # each parameter's update, bf16 (under 1: a
                        # leaf the port leaves unmoved fails)
BLOCK_DX_REL = 1e-3     # one block's bf16 backward: the input gradient,
BLOCK_W_REL = 5e-3      # ... the kernels' and BN affine gradients,
BLOCK_BIAS_REL = 5e-2   # ... the conv biases' (see the docstring)


@pytest.fixture(scope='module')
def r101():
    """The keypoint model of config 5 at the small size, f32: the JAX
    model (built once) and one set of weights."""
    jcfg, tcfg = small_configs(BACKBONE='resnet101', REGRESS_KEYPOINTS=True)
    return jcfg, tcfg, jax_build_model(jcfg), port_variables(tcfg, seed=1)


def test_resnet101_forward_matches_jax(r101):
    jcfg, tcfg, jmodel, tree = r101
    x = kp_batch(3)['images']
    ref = jmodel.apply(tree, jnp.asarray(x), training=True)
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in HEADS:
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-4, k


def test_resnet101_layout(r101):
    _, tcfg, _, tree = r101
    bb = build_model(tcfg, device='cpu').backbone
    stage4 = [n for n in bb.blocks if n.startswith('res4')]
    assert stage4 == ['res4a'] + [f'res4{chr(98 + i)}' for i in range(22)]
    assert len(bb.blocks) == 3 + 4 + 23 + 3
    assert set(tree['params']['backbone']) >= {'res4w', 'bn_conv1'}
    assert 'res4x' not in tree['params']['backbone']
    # the weight bridge round-trips ResNet-101's names
    back = params_to_jax_layout(params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    # the bottleneck backbone takes no shallow depth: make_backbone
    # dispatches resnet18/34 to ResNetShallowBackbone
    with pytest.raises(ValueError, match='resnet18'):
        tresnet.ResNetBackbone('resnet18')


# --------------------------------------------------------------------------
# REMAT


@pytest.fixture(scope='module')
def remat_models():
    """The small keypoint model per dtype (f32, bf16), seeded weights, a
    batch, and its loss and gradients without REMAT."""
    out = {}
    for f16 in (False, True):
        _, tcfg = small_configs(REGRESS_KEYPOINTS=True, F16=f16)
        model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(0))
        batch = _torch_batch(kp_batch(0))
        out[f16] = (model, batch, _loss_and_grads(model, batch))
    return out


def _loss_and_grads(model, batch):
    out = model(batch['images'])
    loss = sum(((out[k] - batch[g]) ** 2).mean()
               for k, g in zip(HEADS, ('gt_loc', 'gt_k1', 'gt_k2')))
    return loss.item(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize('f16', [False, True])
@pytest.mark.parametrize('remat', [True, 'narrow', 'dots'])
def test_remat_gradients_equal_no_remat(remat_models, remat, f16):
    model, batch, (loss0, grads0) = remat_models[f16]
    model.backbone.set_remat(remat)
    try:
        loss, grads = _loss_and_grads(model, batch)
    finally:
        model.backbone.set_remat(False)
    assert loss == loss0
    for g, g0 in zip(grads, grads0):
        assert g.dtype == torch.float32
        assert torch.equal(g, g0)


def _count_conv_calls(model):
    """Forward calls per conv kind ('2b': the 3×3, '2c': the expansion),
    in a dict the hooks fill."""
    calls = {'2b': 0, '2c': 0}
    for blk in model.backbone.blocks:
        mod = model.backbone._modules[blk]
        for kind in calls:
            def hook(*_, kind=kind):
                calls[kind] += 1
            mod._modules[mod.cname + kind].register_forward_hook(hook)
    return calls


@pytest.mark.parametrize('remat,recomputed_2b,recomputed_2c', [
    (False, 0, 0), ('narrow', 0, 1), (True, 1, 1), ('dots', 1, 1)])
def test_remat_recomputes_what_its_policy_says(remat, recomputed_2b,
                                               recomputed_2c):
    """Per block, the backward pass re-runs the 3×3 conv under True and
    'dots', never under 'narrow'; the 1×1 expansion under all three."""
    _, tcfg = small_configs(REGRESS_KEYPOINTS=True, F16=True, REMAT=remat)
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(0))
    calls = _count_conv_calls(model)
    out = model(_torch_batch(kp_batch(0))['images'])
    n = len(model.backbone.blocks)
    assert calls == {'2b': n, '2c': n}
    sum(v.sum() for v in out.values()).backward()
    assert calls == {'2b': n * (1 + recomputed_2b),
                     '2c': n * (1 + recomputed_2c)}


def test_remat_runs_plainly_outside_autograd(monkeypatch):
    """No checkpoint in eval or under no_grad; one per block under
    autograd; an unknown policy raises."""
    _, tcfg = small_configs(REGRESS_KEYPOINTS=True, REMAT='narrow')
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(0))
    x = _torch_batch(kp_batch(0))['images']
    used = []
    real = tresnet.checkpoint
    monkeypatch.setattr(tresnet, 'checkpoint',
                        lambda *a, **k: used.append(1) or real(*a, **k))
    with torch.no_grad():
        model.eval()(x)
        model.train()(x)
    assert not used
    model(x)
    assert len(used) == len(model.backbone.blocks)
    for bad in ('everything', 'save_all'):
        _, cfg = small_configs(REMAT=bad)
        with pytest.raises(ValueError, match='REMAT'):
            build_model(cfg, 'cpu')
        with pytest.raises(ValueError, match='REMAT'):
            model.backbone.set_remat(bad)
    assert all(model.backbone._modules[b].remat == 'narrow'
               for b in model.backbone.blocks)


# --------------------------------------------------------------------------
# bf16 backward


def test_frozen_bn_bf16_backward_keeps_f32_parameter_grads():
    """Mixed-type batch norm under autograd: a bf16 input, f32 affine and
    statistics; the affine gradients come back f32 and equal the f32
    formula on the same bf16 values, the input gradient bf16."""
    bn = tresnet.FrozenBN(4)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.randn(4).astype('f4')))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2, 4).astype('f4')))
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2, 4).astype('f4')))
    x = torch.from_numpy(rng.randn(2, 4, 5, 5).astype('f4')).bfloat16()
    x.requires_grad_(True)
    g = torch.from_numpy(rng.randn(2, 4, 5, 5).astype('f4')).bfloat16()
    y = bn(x)
    assert y.dtype == torch.bfloat16
    y.backward(g)
    assert x.grad.dtype == torch.bfloat16
    assert bn.weight.grad.dtype == bn.bias.grad.dtype == torch.float32
    view = (1, 4, 1, 1)
    xhat = (x.detach().float() - bn.running_mean.view(view)) / torch.sqrt(
        bn.running_var.view(view) + tresnet.BN_EPS)
    torch.testing.assert_close(bn.weight.grad,
                               (g.float() * xhat).sum((0, 2, 3)),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.bias.grad, g.float().sum((0, 2, 3)),
                               rtol=1e-5, atol=1e-5)
    scale = bn.weight.detach() / torch.sqrt(bn.running_var + tresnet.BN_EPS)
    torch.testing.assert_close(x.grad, (g.float() * scale.view(view))
                               .bfloat16(), rtol=0, atol=0)


def test_bf16_block_backward_matches_jax():
    """res2a (the conv block 64 -> 64, 3x3, 256) in bf16 with random conv
    biases and BN: forward and the vjp of one cotangent, port against
    flax."""
    rng = np.random.RandomState(11)
    tblock = tresnet.BottleneckBlock(64, (64, 64, 256), 2, 'a', 1, True)
    with torch.no_grad():
        for name, p in tblock.named_parameters():
            p.copy_(torch.from_numpy(
                (rng.randn(*p.shape) * (0.1 if p.ndim > 1 else 0.5))
                .astype('f4')))
    tree = _randomize_bn(params_to_jax_layout(tblock.state_dict()), rng)
    tblock.load_state_dict(params_from_jax(tree))
    jblock = jresnet.BottleneckBlock((64, 64, 256), 2, 'a', 1, True,
                                     dtype=jnp.bfloat16)
    x = (rng.randn(2, 16, 16, 64) * 2).astype('f4')
    g = rng.randn(2, 16, 16, 256).astype('f4')

    def jf(params, xx):
        return jblock.apply({'params': params,
                             'batch_stats': tree['batch_stats']}, xx)

    jy, vjp = jax.vjp(jf, tree['params'], jnp.asarray(x, jnp.bfloat16))
    jgp, jgx = vjp(jnp.asarray(g, jnp.bfloat16))

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16()
    xt.requires_grad_(True)
    y = tblock(xt)
    y.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).bfloat16())

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))
    got_y = y.detach().float().numpy().transpose(0, 2, 3, 1)
    assert (got_y != f32(jy)).mean() <= 0.01
    got_gx = xt.grad.float().numpy().transpose(0, 2, 3, 1)
    assert rel_l2(got_gx, f32(jgx)) <= BLOCK_DX_REL
    got_gp = params_to_jax_layout(
        {n: p.grad for n, p in tblock.named_parameters()})['params']
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_gp),
                                 jax.tree_util.tree_leaves_with_path(jgp)):
        name = jax.tree_util.keystr(path)
        conv_bias = name.startswith("['res") and name.endswith("['bias']")
        assert a.dtype == np.float32
        assert rel_l2(a, f32(b)) <= (BLOCK_BIAS_REL if conv_bias
                                     else BLOCK_W_REL), name


# --------------------------------------------------------------------------
# the F16 train step


@pytest.mark.parametrize('heads', ['flagship', 'keypoints'])
def test_f16_train_step_matches_jax(heads):
    over = dict(F16=True)
    if heads == 'keypoints':
        over['REGRESS_KEYPOINTS'] = True
    jcfg, tcfg = small_configs(**over)
    tree = port_variables(tcfg, seed=2)
    batch = kp_batch(5) if heads == 'keypoints' else _batch(jcfg, seed=5)
    jmodel = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        jmodel, jcfg, tx, trainable=jstate.trainable_mask(state.params, 'all'))
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    tm = make_train_step(model, tcfg, make_optimizer(tcfg),
                         trainable=trainable_mask(model, 'all'),
                         device='cpu')(_torch_batch(batch))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].dtype == torch.float32
        assert abs(float(tm[k]) - float(jm[k])) <= \
            LOSS_REL * abs(float(jm[k])), k
    w0 = jax.tree_util.tree_leaves(tree['params'])
    wj = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, state.params))
    wt = jax.tree_util.tree_leaves(
        params_to_jax_layout(model.state_dict())['params'])
    for a, b, c in zip(wt, wj, w0):
        du, dj = np.float64(a) - c, np.float64(b) - c
        assert np.linalg.norm(du - dj) <= PARAM_REL * np.linalg.norm(dj)
    _, ft = _flat(params_to_jax_layout(model.state_dict())['params'])
    _, fj = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    _, f0 = _flat(tree['params'])
    assert np.linalg.norm(ft - fj) <= TREE_REL * np.linalg.norm(fj - f0)
