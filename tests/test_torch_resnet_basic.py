"""ResNet-18/34 in the port (`models/resnet.py` `BasicBlock`,
`ResNetShallowBackbone`, `make_backbone`; the basic-block int8 twin of
`models/quant.py`; the weight bridge, folding and the h5 files) against
the JAX package's, on the same seeded weights and inputs at 64×64,
batch 2, with quaternion regression (benchmark config 2's heads).

Tolerances:
  * float forward: relative L2 1e-4 a head (convolutions summed in
    another order by another library);
  * validation and train step (quaternion, Euler and angle-axis heads;
    one step each, preprocess None, the JAX steps jitted): updated
    parameters within 1e-3 in update units, metrics within 1e-5 relative
    (the bounds of tests/test_torch_train.py);
  * REMAT: gradients equal to those without, element for element (the
    checkpoint recomputes the same operations);
  * weights through the bridge, the folding and an h5 file: exact (the
    folding's arithmetic at rtol 1e-6, as tests/test_torch_quant.py);
  * int8 twin with the JAX package's calibrated and smoothed weights and
    scales, in the f32 and the bf16 (F16) epilogue modes, on the 7×7 stem
    and rewritten to s2d ('conv0'): the orientation logits (the int8
    body end to end, a soft-classification head) bit-exact, `loc` within
    relative L2 1e-3 (f32) or 1e-2 (bf16) (its final dense reorders);
    the float twin within 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu.checkpoint import h5_import as jh5
from ursonet_tpu.models import quant as jq
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_eval_step as jax_make_eval_step
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint import h5_import as th5
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models import quant as tq
from ursonet_torch.models import resnet as tresnet
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, make_train_step
from test_torch_model import _randomize_bn
from test_torch_s2d import _s2d_np
from test_torch_train import _flat, _rel, _torch_batch
from torch_parity import rel_l2, small_configs, unit_quats

torch.set_num_threads(1)

SHAPE = (2, 64, 64, 3)


def _configs(arch='resnet18', **kw):
    return small_configs(BACKBONE=arch, REGRESS_ORI=True, **kw)


def _x(seed=1):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32) * 50


def _variables(tcfg, seed):
    """Variables in the JAX layout, from the port's initializer (the JAX
    package's: LeCun truncated normal) with random batch-norm statistics
    and affine parameters; no JAX init to compile."""
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(seed))
    return _randomize_bn(params_to_jax_layout(model.state_dict()),
                         np.random.RandomState(seed))


def _port_model(tcfg, tree):
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    return model


def _port_forward(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))


@pytest.fixture(scope='module')
def r18():
    """JAX ResNet-18 with quaternion regression: model and variables."""
    jcfg, tcfg = _configs()
    jmodel = jax_build_model(jcfg)
    return jcfg, tcfg, jmodel, _variables(tcfg, 3)


# --------------------------------------------------------------------------
# the float model


@pytest.mark.parametrize('arch', ['resnet18', 'resnet34'])
def test_forward_matches_jax(r18, arch):
    if arch == 'resnet18':
        _, tcfg, jmodel, tree = r18
    else:
        jcfg, tcfg = _configs(arch)
        jmodel = jax_build_model(jcfg)
        tree = _variables(tcfg, 4)
    x = _x()
    ref = jmodel.apply(tree, jnp.asarray(x), training=False)
    model = _port_model(tcfg, tree)
    bb = model.backbone
    reps = {'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3)}[arch]
    assert bb.blocks == [f'stage{s + 1}_unit{u + 1}'
                         for s, n in enumerate(reps) for u in range(n)]
    assert model.bottleneck_layer.in_channels == 512
    # the reference's convs are bias-free, the stem included
    assert bb.conv0.bias is None and bb.stage2_unit1.stage2_unit1_sc.bias \
        is None
    out = _port_forward(model, x)
    for k in ('loc', 'ori'):
        assert out[k].shape == ref[k].shape
        assert rel_l2(out[k].numpy(), ref[k]) <= 1e-4, k


def test_make_backbone_dispatch_and_inner_width():
    assert isinstance(tresnet.make_backbone('resnet34'),
                      tresnet.ResNetShallowBackbone)
    assert isinstance(tresnet.make_backbone('resnet50'),
                      tresnet.ResNetBackbone)
    with pytest.raises(ValueError, match='INNER_WIDTH_MULT'):
        tresnet.make_backbone('resnet18', inner_mult=0.5)
    with pytest.raises(ValueError, match='resnet152'):
        tresnet.make_backbone('resnet152')
    _, tcfg = _configs(INNER_WIDTH_MULT=0.5)
    with pytest.raises(ValueError, match='INNER_WIDTH_MULT'):
        build_model(tcfg, device='cpu')


def test_s2d_stem_forward_matches_jax():
    """STEM_SPACE_TO_DEPTH builds 'conv0' as the (4,4,12,64) conv."""
    jcfg, tcfg = _configs(STEM_SPACE_TO_DEPTH=True)
    jmodel = jax_build_model(jcfg)
    tree = _variables(tcfg, 6)
    assert tree['params']['backbone']['conv0']['kernel'].shape \
        == (4, 4, 12, 64)
    x = _x(2)
    ref = jmodel.apply(tree, jnp.asarray(x), training=False)
    out = _port_forward(_port_model(tcfg, tree), x)
    for k in ('loc', 'ori'):
        assert rel_l2(out[k].numpy(), ref[k]) <= 1e-4, k


# --------------------------------------------------------------------------
# the train step


def _euler_tree(tree):
    """The quaternion tree with its final orientation dense cut to the
    3 outputs of the Euler / angle-axis head ('ori_final')."""
    tree = copy.deepcopy(tree)
    head = tree['params']['ori_head']
    q = head.pop('ori_q')
    head['ori_final'] = {'kernel': q['kernel'][:, :3].copy(),
                         'bias': q['bias'][:3].copy()}
    return tree


@pytest.mark.parametrize('param', ['quaternion', 'euler_angles',
                                   'angle_axis'])
def test_train_and_validation_steps_match_jax(r18, param):
    """The validation step's metrics, then one train step, from the same
    weights on the same molded batch."""
    _, _, _, tree = r18
    jcfg, tcfg = _configs(ORIENTATION_PARAM=param, ROT_AUG=False)
    if param != 'quaternion':
        tree = _euler_tree(tree)
    rng = np.random.RandomState(5)
    b = jcfg.BATCH_SIZE
    batch = {
        'images': _x(5),
        'gt_loc': np.stack([rng.uniform(-3, 3, b), rng.uniform(-3, 3, b),
                            rng.uniform(5, 40, b)], 1).astype(np.float32),
        'gt_ori': unit_quats(rng, b) if param == 'quaternion'
        else rng.uniform(-3, 3, (b, 3)).astype(np.float32)}
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jmodel = jax_build_model(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jv = jax_make_eval_step(jmodel, jcfg)(state, jbatch,
                                          jax.random.PRNGKey(0))
    jstep = jax_make_train_step(
        jmodel, jcfg, tx, trainable=jstate.trainable_mask(state.params,
                                                          'all'))
    state, jm = jstep(state, jbatch, jax.random.PRNGKey(0))
    model = _port_model(tcfg, tree)
    tv = make_eval_step(model, tcfg, device='cpu')(_torch_batch(batch))
    assert set(tv) == set(jv)
    for k, v in jv.items():
        assert _rel(tv[k], float(v)) <= 1e-5, k
    tm = make_train_step(model, tcfg, make_optimizer(tcfg),
                         trainable=trainable_mask(model, 'all'),
                         device='cpu')(_torch_batch(batch))
    names_j, wj = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    names_t, wt = _flat(params_to_jax_layout(model.state_dict())['params'])
    assert names_j == names_t
    _, w0 = _flat(tree['params'])
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0) <= 1e-3
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert _rel(tm[k], float(v)) <= 1e-5, k


@pytest.mark.parametrize('remat', [True, 'narrow'])
def test_remat_gradients_equal_those_without(r18, remat):
    """Each basic block is one checkpoint under every policy; the
    recomputed forward gives the same gradients, and no REMAT outside
    autograd changes nothing."""
    _, tcfg, _, tree = r18
    x = torch.from_numpy(_x(7).transpose(0, 3, 1, 2).copy())
    grads = {}
    for policy in (False, remat):
        model = _port_model(tcfg, tree)
        model.backbone.set_remat(policy)
        out = model.train()(x)
        (out['loc'].square().sum() + out['ori'].sum()).backward()
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in grads[False].items():
        assert torch.equal(grads[remat][n], g), n


# --------------------------------------------------------------------------
# weights: bridge, folding, h5


def test_weight_bridge_and_folding_match_jax(r18):
    jcfg, tcfg, _, tree = r18
    back = params_to_jax_layout(params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert set(back['batch_stats']['backbone']['stage1_unit1']) \
        == {'stage1_unit1_bn2'}
    want = jq.flatten_folded(tree['params'], tree['batch_stats'], jcfg)
    got = tq.flatten_folded(tree['params'], tree['batch_stats'], tcfg)
    assert set(got) == set(want)
    for site, (w, b) in want.items():
        np.testing.assert_allclose(got[site][0], w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[site][1], b, rtol=1e-6, atol=1e-7)
    # conv2 and the shortcut have no batch norm: identity, a zero bias
    k, b = got['stage2_unit1_conv2']
    np.testing.assert_array_equal(
        k, tree['params']['backbone']['stage2_unit1']['stage2_unit1_conv2']
        ['kernel'])
    assert b.shape == (128,) and not b.any()
    mcfg = tq.QuantizedModel(tcfg, got, 'cpu')._mcfg
    for arch in ('resnet18', 'resnet34'):
        m = dict(mcfg, backbone=arch)
        assert tq.migration_groups(m) == jq.migration_groups(m)
        assert tq.float_sites(m) == jq.float_sites(m)


def test_h5_round_trip_both_ways(r18, tmp_path):
    jcfg, tcfg, jmodel, tree = r18
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(5))
    path = str(tmp_path / 'port.h5')
    th5.save_keras_h5(path, model.state_dict())
    params, stats, report = jh5.load_keras_h5(path, tree['params'],
                                              tree['batch_stats'])
    assert not report['unmatched'] and not report['mismatched']
    want = params_to_jax_layout(model.state_dict())
    got = jax.tree_util.tree_leaves_with_path(
        {'params': params, 'batch_stats': stats})
    assert [p for p, _ in got] == [
        p for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    for (p, a), b in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    # and the JAX package's file into the port
    jpath = str(tmp_path / 'jax.h5')
    jh5.save_keras_h5(jpath, tree['params'], tree['batch_stats'])
    sd, report = th5.load_keras_h5(jpath, model.state_dict())
    assert not report['unmatched'] and not report['mismatched']
    ref = params_from_jax(tree)
    assert sd.keys() == ref.keys()
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k


# --------------------------------------------------------------------------
# the int8 twin


@pytest.fixture(scope='module')
def jax_q18():
    """ResNet-18 with orientation soft-classification (its logits are
    int8 end to end), per epilogue mode and stem: the JAX QuantizedModel
    calibrated on uint8 images and smoothed, built on first use."""
    cache = {}

    def get(f16, s2d):
        key = (f16, s2d)
        if key not in cache:
            knobs = dict(QUANT_STEM_S2D=True, QUANT_HOST_S2D=True) \
                if s2d else {}
            jcfg, tcfg = small_configs(BACKBONE='resnet18', F16=f16, **knobs)
            if 'tree' not in cache:
                cache['tree'] = _variables(tcfg, 8)
            qm = jq.QuantizedModel.from_variables(
                jcfg, cache['tree']['params'], cache['tree']['batch_stats'])
            x = np.random.RandomState(0).randint(0, 256, SHAPE).astype(
                np.uint8)
            qm.calibrate(jnp.asarray(_s2d_np(x) if s2d else x))
            qm.smooth(0.5)
            cache[key] = dict(qm=qm, tcfg=tcfg)
        return cache[key]

    return get


@pytest.mark.parametrize('f16,s2d,u8', [
    (False, False, True), (False, False, False), (False, True, True),
    (True, False, True), (True, True, True), (True, True, False)])
def test_int8_twin_matches_jax(jax_q18, f16, s2d, u8):
    """JAX's calibrated and smoothed weights and scales carried over; on
    the s2d stem, uint8 pixels take the fused stem and molded floats the
    unfused route."""
    pair = jax_q18(f16, s2d)
    want_qm = pair['qm']
    qm = tq.QuantizedModel(pair['tcfg'],
                           {k: (np.array(w), np.array(b))
                            for k, (w, b) in want_qm.flat.items()}, 'cpu')
    qm.act_scales = dict(want_qm.act_scales)
    assert qm._mcfg == want_qm._mcfg
    assert qm._mcfg['stem_s2d'] == s2d
    assert qm.flat['conv0'][0].shape[:2] == ((4, 4) if s2d else (7, 7))
    x = np.random.RandomState(2).randint(0, 256, SHAPE).astype(np.uint8)
    if not u8:
        x = x.astype(np.float32) - np.asarray(pair['tcfg'].MEAN_PIXEL,
                                              np.float32)
    if s2d:
        x = _s2d_np(x)
    ref = {k: np.asarray(v) for k, v in want_qm(jnp.asarray(x)).items()}
    got = qm(x)
    np.testing.assert_array_equal(got['ori'].numpy(), ref['ori'])
    assert rel_l2(got['loc'].numpy(), ref['loc']) <= (1e-2 if f16 else 1e-3)
    plain = qm(x, plain=True)
    for k in got:
        torch.testing.assert_close(plain[k], got[k], rtol=0, atol=0)
    if not f16:
        twin = qm.float_twin(x)
        for k, v in want_qm.float_twin(jnp.asarray(x)).items():
            assert rel_l2(twin[k].numpy(), v) <= 1e-5, k


def test_int8_sites_of_the_basic_block():
    """The port's own calibration names the basic blocks' sites (the
    shortcut's requantize, the join's), and the int8 forward of a
    random-init ResNet-18 stays within the random-init gate of its float
    twin."""
    _, tcfg = small_configs(BACKBONE='resnet18')
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(9))
    t = params_to_jax_layout(model.state_dict())
    qm = tq.QuantizedModel.from_variables(tcfg, t['params'],
                                          t['batch_stats'], 'cpu')
    x = np.random.RandomState(3).randint(0, 256, SHAPE).astype(np.uint8)
    qm.calibrate(x)
    assert {'conv0/out', 'stage2_unit1_sc/out', 'stage4_unit2_/out'} \
        <= set(qm.act_scales)
    twin, q = qm.float_twin(x), qm(x)
    for k in twin:
        assert rel_l2(q[k].numpy(), twin[k].numpy()) \
            < tq.RANDOM_INIT_GATE_REL, k
