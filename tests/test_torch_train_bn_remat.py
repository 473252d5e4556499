"""Batch-statistics BN (TRAIN_BN None / True) in the rest of the port:
REMAT's recomputed blocks, int8 PTQ of a TRAIN_BN=None model against the
JAX package, and DEBUG_NANS in the train step. ResNet-18 at 64×64
(ResNet-50 where the bottleneck block's REMAT policies need it), batch
2, the port's seeded weights with random BN.

Tolerances:
  * REMAT True and 'narrow': the running statistics after one step equal
    to those without REMAT, bit for bit (a double update would miss by
    ~1%: 0.01 of the batch statistics);
  * int8 PTQ under TRAIN_BN=None: the folded sites 1e-6, the int8 body
    (the orientation logits) bit-exact with JAX's calibration, the other
    heads 1e-3; TRAIN_BN=True raises in both packages;
  * the head BNs of TRAIN_BN=True (gamma, beta and the running
    statistics of '{loc,ori}_bn_{i}') through Keras h5 and msgpack
    snapshots, each package's file read by the other: every value equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ursonet_tpu.checkpoint import h5_import as jh5
from ursonet_tpu.checkpoint import store as jstore
from ursonet_tpu.models import quant as jq
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_torch.checkpoint import h5_import as th5
from ursonet_torch.checkpoint import store as tstore
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models import quant as tq
from ursonet_torch.models.resnet import commit_batch_stats
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import check_nans, make_train_step
from test_torch_engine_parity import _trees_equal
from test_torch_keypoints import port_variables
from test_torch_model import jax_variables
from test_torch_train import _batch, _torch_batch
from test_torch_train_bn import _configs
from torch_parity import rel_l2

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# REMAT


@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'bf16'])
def test_remat_updates_statistics_once(f16):
    """A checkpointed block reruns its forward in the backward pass; the
    running statistics after one step equal those without REMAT."""
    _, tcfg = _configs(None, BACKBONE='resnet50', F16=f16)
    tree = port_variables(tcfg, seed=6)
    batch = _torch_batch(_batch(tcfg, seed=6))
    stats = {}
    for remat in (False, True, 'narrow'):
        tcfg.REMAT = remat
        model = build_model(tcfg, device='cpu')
        model.load_state_dict(params_from_jax(tree))
        make_train_step(model, tcfg, make_optimizer(tcfg),
                        device='cpu')(batch)
        stats[remat] = {k: v.clone() for k, v in model.state_dict().items()
                        if 'running_' in k}
    moved = [k for k, v in stats[False].items() if not torch.equal(
        v, params_from_jax(tree)[k])]
    assert len(moved) == len(stats[False])
    for remat in (True, 'narrow'):
        for k, v in stats[False].items():
            assert torch.equal(stats[remat][k], v), (remat, k)


# --------------------------------------------------------------------------
# int8 PTQ


def _images(seed, n=2, dim=64):
    return np.random.RandomState(seed).randint(
        0, 256, (n, dim, dim, 3)).astype(np.uint8)


@pytest.mark.parametrize('train_bn', [None, True])
def test_quantize_under_train_bn(train_bn):
    """TRAIN_BN=None folds the trained running statistics and serves, as
    the JAX gate (`getattr(config, 'TRAIN_BN', False)`) lets None
    through; TRAIN_BN=True raises in both packages."""
    jcfg, tcfg = _configs(train_bn)
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(port_variables(tcfg, seed=7)))
    make_train_step(model, tcfg, make_optimizer(tcfg), device='cpu')(
        _torch_batch(_batch(jcfg, seed=7)))
    tree = params_to_jax_layout(model.state_dict())
    if train_bn is True:
        with pytest.raises(NotImplementedError, match='TRAIN_BN'):
            jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                             tree['batch_stats'])
        with pytest.raises(NotImplementedError, match='TRAIN_BN'):
            tq.QuantizedModel.from_variables(tcfg, tree['params'],
                                             tree['batch_stats'], 'cpu')
        return
    jqm = jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                           tree['batch_stats'])
    tqm = tq.QuantizedModel.from_variables(tcfg, tree['params'],
                                           tree['batch_stats'], 'cpu')
    assert set(tqm.flat) == set(jqm.flat)
    for site, (w, b) in jqm.flat.items():
        np.testing.assert_allclose(tqm.flat[site][0], w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tqm.flat[site][1], b, rtol=1e-6,
                                   atol=1e-7)
    jqm.calibrate(jnp.asarray(_images(0)))
    tqm.act_scales = dict(jqm.act_scales)
    x = _images(1)
    ref = {k: np.asarray(v) for k, v in jqm(jnp.asarray(x)).items()}
    got = tqm(x)
    for k in ref:
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-3, k
    np.testing.assert_array_equal(got['ori'].numpy(), ref['ori'])


# --------------------------------------------------------------------------
# DEBUG_NANS


def test_check_nans_names_the_step():
    _, tcfg = _configs(None)
    model = build_model(tcfg, device='cpu')
    step = make_train_step(model, tcfg, make_optimizer(tcfg), device='cpu')
    batch = _torch_batch(_batch(tcfg, seed=8))
    check_nans('train step 0', step(batch), model)      # finite: no raise
    batch['images'][0, 0, 3, 3] = float('nan')
    with pytest.raises(FloatingPointError, match='train step 1'):
        check_nans('train step 1', step(batch), model)
    # the NaN batch poisoned the running statistics as it would in JAX
    assert commit_batch_stats(model) == 0
    assert any(torch.isnan(b).any() for b in model.buffers())


# --------------------------------------------------------------------------
# the head BNs in checkpoints


def test_head_bn_crosses_h5_and_msgpack(tmp_path):
    jcfg, tcfg = _configs(True)
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(port_variables(tcfg, seed=9)))
    want = params_to_jax_layout(model.state_dict())
    for side in ('params', 'batch_stats'):
        assert {'loc_bn_0', 'ori_bn_0'} <= set(want[side]['loc_head']) | \
            set(want[side]['ori_head'])
    # the JAX package's model of the same config has the same tree
    jtree = jax_variables(jax_build_model(jcfg), (2, 64, 64, 3), seed=1)
    assert jax.tree_util.tree_structure(jtree) == \
        jax.tree_util.tree_structure(want)
    # Keras h5: the port's file read by JAX, JAX's file read by the port
    path = str(tmp_path / 'port.h5')
    th5.save_keras_h5(path, model.state_dict())
    params, stats, report = jh5.load_keras_h5(path, jtree['params'],
                                              jtree['batch_stats'])
    assert not report['unmatched'] and not report['mismatched']
    _trees_equal({'params': params, 'batch_stats': stats}, want)
    jpath = str(tmp_path / 'jax.h5')
    jh5.save_keras_h5(jpath, want['params'], want['batch_stats'])
    other = build_model(tcfg, 'cpu', torch.Generator().manual_seed(3))
    sd, _ = th5.load_keras_h5(jpath, other.state_dict())
    _trees_equal(params_to_jax_layout(sd), want)
    # msgpack snapshots
    mpath = str(tmp_path / 'port.msgpack')
    tstore.save_weights_file(mpath, model.state_dict())
    _trees_equal(jax.tree_util.tree_map(np.asarray,
                                        jstore.load_weights_file(mpath)),
                 want)
