"""The port's UrsoNet forward pass against the JAX package's, with the
JAX-initialized weights (batch-norm statistics and affine parameters
randomized) converted by `params_from_jax`.

Tolerance: the `loc` and `ori` outputs within a relative L2 error of
1e-4 in f32 (convolutions summed in another order by another library).
"""

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_torch import presets
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models.resnet import BN_EPS, FrozenBN, same_pads
from ursonet_torch.models.ursonet import UrsoNetModule, build_model
from torch_parity import rel_l2, small_configs

torch.set_num_threads(1)


def _randomize_bn(tree, rng):
    """Random BN statistics and affine parameters, so the conversion and
    the frozen-BN formula are exercised (the initializer leaves them
    trivial)."""
    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in ('mean', 'bias') and 'bn' in path:
                node[k] = rng.randn(*v.shape).astype(np.float32) * 0.1
            elif k in ('var', 'scale') and 'bn' in path:
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    walk(tree['params'])
    walk(tree['batch_stats'])
    return tree


def jax_variables(model, shape, seed=0):
    """JAX-initialized variables as nested dicts of numpy arrays."""
    v = nn.unbox(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros(shape, jnp.float32)))
    tree = jax.tree_util.tree_map(np.array, {'params': v['params'],
                                             'batch_stats': v['batch_stats']})
    return _randomize_bn(tree, np.random.RandomState(seed))


@pytest.mark.parametrize('mode,dim,min_dim,heads', [
    ('square', 64, 64, {}),
    ('pad64', 192, 128, {}),
    # location soft-classification + quaternion regression (l2norm head)
    ('square', 64, 64, dict(REGRESS_LOC=False, LOC_BINS_PER_DIM=4,
                            REGRESS_ORI=True))])
def test_forward_matches_jax(mode, dim, min_dim, heads):
    jcfg, tcfg = small_configs(mode=mode, dim=dim, IMAGE_MIN_DIM=min_dim,
                               **heads)
    h, w = int(jcfg.IMAGE_SHAPE[0]), int(jcfg.IMAGE_SHAPE[1])
    jmodel = jax_build_model(jcfg)
    tree = jax_variables(jmodel, (2, h, w, 3))
    x = np.random.RandomState(1).randn(2, h, w, 3).astype(np.float32) * 50
    ref = jmodel.apply(tree, jnp.asarray(x), training=True)

    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    model.train()              # frozen BN: training mode changes nothing
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in ('loc', 'ori'):
        assert got[k].shape == ref[k].shape
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-4, k


def test_params_round_trip():
    jcfg, _ = small_configs()
    tree = jax_variables(jax_build_model(jcfg), (1, 64, 64, 3), seed=3)
    back = params_to_jax_layout(params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_same_padding_and_stem_hazards():
    # Flax 'SAME' at stride 2: (0,1) on even sizes, (1,1) on odd ones
    assert same_pads(8, 3, 2) == (0, 1)
    assert same_pads(7, 3, 2) == (1, 1)
    assert same_pads(10, 3, 1) == (1, 1)
    _, tcfg = small_configs()
    model = build_model(tcfg, device='cpu')
    conv1 = model.backbone.conv1
    assert conv1.kernel_size == (7, 7) and conv1.stride == (2, 2)
    assert conv1.padding == (3, 3)       # explicit (3,3) pad, then VALID
    blk = model.backbone.res3a
    assert blk.res3a_branch2a.kernel_size == (1, 1)
    assert blk.res3a_branch2a.stride == (2, 2)
    assert blk.res3a_branch1.stride == (2, 2)
    assert blk.res3a_branch1.padding == (0, 0)
    assert model.bottleneck_layer.padding == (0, 0)  # padded by pad_same


def test_frozen_bn_uses_running_stats_and_trains_affine():
    assert BN_EPS == 1e-3
    bn = FrozenBN(4)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([1.0, 2, 3, 4]))
        bn.running_var.copy_(torch.tensor([4.0, 1, 0.25, 9]))
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    bn.train()
    y = bn(x)
    want = (x - bn.running_mean.view(1, 4, 1, 1)) / torch.sqrt(
        bn.running_var.view(1, 4, 1, 1) + 1e-3)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(bn.running_mean, torch.tensor([1.0, 2, 3, 4]))
    y.sum().backward()
    assert bn.weight.grad is not None and bn.bias.grad is not None
    assert {n for n, _ in bn.named_parameters()} == {'weight', 'bias'}
    with pytest.raises(NotImplementedError):
        FrozenBN(4, train_bn=None)


def test_flagship_model_shapes_and_names():
    cfg = presets.benchmark_config(3)
    with torch.device('meta'):
        model = UrsoNetModule((512, 640), 'resnet50', 128, 1024, 1, True,
                              False, 'quaternion', 16, 24)
    sd = model.state_dict()
    for key in ('backbone.conv1.weight', 'backbone.bn_conv1.running_var',
                'backbone.res3a.res3a_branch2a.weight',
                'backbone.res4f.bn4f_branch2c.weight',
                'loc_head.loc_dense_0.weight', 'loc_head.loc_final.bias',
                'ori_head.ori_final.weight'):
        assert key in sd, key
    assert 'backbone.res4g.res4g_branch2a.weight' not in sd   # resnet50
    assert sd['loc_head.loc_dense_0.weight'].shape == (
        1024, cfg.head_input_features())
    assert sd['ori_head.ori_final.weight'].shape == (24 ** 3, 1024)
    assert sd['loc_head.loc_final.weight'].shape == (3, 1024)
