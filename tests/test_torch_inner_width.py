"""The pruned-width flagship (INNER_WIDTH_MULT) in the port against the
JAX package, on the CPU: `scale_inner`, the scaled bottleneck, the
pruning tool (`ursonet_torch/prune_inner.py` against
`tools/prune_inner.py`), checkpoints of pruned trees in both packages'
layouts, the pruned model's float forward and train step, and the
command line's `--set` of the serving knobs.

Tolerances: `scale_inner`, the pruned arrays, the tool's report and the
checkpoint round trips exact; the float forward within relative L2 1e-4
per head and one train step within 1e-3 in update units, as
tests/test_torch_model.py and tests/test_torch_train.py hold the full
model (f32 sums in another order).
"""

import copy
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu.checkpoint import store as jstore
from ursonet_tpu.models.resnet import scale_inner as jax_scale_inner
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch import prune_inner
from ursonet_torch.checkpoint import store
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.checkpoint.msgpack import msgpack_restore, \
    msgpack_serialize
from ursonet_torch.models.resnet import scale_inner
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_train_step
from test_torch_model import jax_variables
from test_torch_train import _batch, _flat, _torch_batch
from torch_parity import rel_l2, small_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'tools'))
import prune_inner as jax_prune_inner  # noqa: E402

torch.set_num_threads(2)


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg='/'.join(p))


@pytest.fixture(scope='module')
def full_tree():
    """The small flagship-like ResNet-50's JAX variables (numpy), with
    ties in the importance of res3a's first inner space: half its BN
    scales zeroed."""
    jcfg, _ = small_configs()
    tree = jax_variables(jax_build_model(jcfg), (2, 64, 64, 3), seed=0)
    bn = tree['params']['backbone']['res3a']['bn3a_branch2a']['bn']
    bn['scale'] = np.where(np.arange(bn['scale'].shape[0]) % 2, 0.0,
                           bn['scale']).astype(np.float32)
    return tree


def test_scale_inner_matches_jax():
    for f in (8, 16, 24, 40, 64, 100, 128, 256, 512, 1000, 2048):
        for mult in (0.01, 0.1, 0.25, 0.33, 0.5, 0.6, 0.75, 0.9, 1.0, 1.3,
                     2.0):
            assert scale_inner(f, mult) == jax_scale_inner(f, mult), (f, mult)
    assert [scale_inner(f, 0.6) for f in (64, 128, 256, 512)] \
        == [40, 80, 152, 304]


@pytest.mark.parametrize('mult', [0.5, 0.6])
def test_inner_width_mult_scales_inner_only(mult):
    """The inner widths scale; stream widths and every name stay (as
    tests/test_model.py::test_inner_width_mult_scales_inner_only)."""
    _, tcfg = small_configs(INNER_WIDTH_MULT=mult)
    model = build_model(tcfg, device='cpu')
    bb = model.backbone
    f = scale_inner(128, mult)
    assert bb.res3a.res3a_branch2b.weight.shape == (f, f, 3, 3)
    assert bb.res3a.res3a_branch2c.weight.shape == (512, f, 1, 1)
    assert bb.res3a.res3a_branch1.weight.shape == (512, 256, 1, 1)
    g = scale_inner(512, mult)
    assert bb.res5c.res5c_branch2b.weight.shape == (g, g, 3, 3)
    assert bb.conv1.weight.shape == (64, 3, 7, 7)
    _, full = small_configs()
    assert list(model.state_dict()) == \
        list(build_model(full, device='cpu').state_dict())


@pytest.mark.parametrize('mult', [1.0, 0.5, 0.6])
def test_prune_tree_matches_the_jax_tool(full_tree, mult):
    """The same channels (ties included), slices and report as
    tools/prune_inner.py; at 1.0 the tree as it was."""
    want, got = copy.deepcopy(full_tree), copy.deepcopy(full_tree)
    report = jax_prune_inner.prune_tree(want, mult)
    assert prune_inner.prune_tree(got, mult) == report
    assert len(report) == 32        # 16 blocks x 2 inner spaces
    _assert_trees_equal(got, want)
    if mult == 1.0:
        _assert_trees_equal(got, full_tree)
    w = got['params']['backbone']['res4a']['res4a_branch2b']['kernel']
    assert w.shape == (3, 3) + (scale_inner(256, mult),) * 2


def test_prune_inner_command_matches_the_jax_tool(full_tree, tmp_path,
                                                  capsys):
    """`python -m ursonet_torch.prune_inner` and tools/prune_inner.py on
    one weights file: the same report and the same tree out, which each
    package's loader reads."""
    src = str(tmp_path / 'full.msgpack')
    with open(src, 'wb') as f:
        f.write(msgpack_serialize(full_tree))
    outs = {}
    for name, tool in (('port', prune_inner), ('jax', jax_prune_inner)):
        outs[name] = str(tmp_path / f'{name}.msgpack')
        tool.main([src, outs[name], '--mult', '0.6'])
        lines = capsys.readouterr().out.splitlines()
        assert lines[-1] == f'wrote {outs[name]}'
        outs[name + ' report'] = lines[:-1]
    assert outs['port report'] == outs['jax report']
    assert outs['port report'][0].startswith('pruned 32 inner channel spaces')
    with open(outs['port'], 'rb') as f:
        port = msgpack_restore(f.read())
    _assert_trees_equal(port, jstore.load_weights_file(outs['jax']))
    _assert_trees_equal(jstore.load_weights_file(outs['port']), port)


@pytest.fixture(scope='module')
def pruned():
    """The pruned tree at 0.5 and both packages' models of that width."""
    jcfg, tcfg = small_configs(INNER_WIDTH_MULT=0.5)
    full, _ = small_configs()
    tree = jax_variables(jax_build_model(full), (2, 64, 64, 3), seed=3)
    jax_prune_inner.prune_tree(tree, 0.5)
    return dict(tree=tree, jcfg=jcfg, tcfg=tcfg,
                jmodel=jax_build_model(jcfg))


def test_pruned_checkpoint_round_trips(pruned, tmp_path):
    """A pruned tree converts to the port's state dict and back exactly;
    a pruned msgpack of either package loads into the other's
    INNER_WIDTH_MULT model (shapes from the tree: no conversion code
    knows the widths)."""
    tree = pruned['tree']
    model = build_model(pruned['tcfg'], device='cpu')
    model.load_state_dict(params_from_jax(tree))
    back = params_to_jax_layout(model.state_dict())
    back['params'].pop('loss_log_vars', None)
    _assert_trees_equal(back, {'params': {k: v for k, v in
                                          tree['params'].items()},
                               'batch_stats': tree['batch_stats']})
    path = str(tmp_path / 'port.msgpack')
    store.save_weights_file(path, model.state_dict())
    jtree = jstore.load_weights_file(path)
    out = pruned['jmodel'].apply(jtree, jnp.zeros((1, 64, 64, 3)),
                                 training=False)
    assert all(np.isfinite(np.asarray(v)).all() for v in out.values())
    jpath = str(tmp_path / 'jax.msgpack')
    jstore.save_weights_file(jpath, tree['params'], tree['batch_stats'])
    model2 = build_model(pruned['tcfg'], device='cpu')
    model2.load_state_dict(store.load_weights_file(jpath))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(model2.state_dict()[k], v, rtol=0, atol=0)


def test_pruned_forward_matches_jax(pruned):
    tree = pruned['tree']
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32) * 50
    ref = pruned['jmodel'].apply(tree, jnp.asarray(x), training=False)
    model = build_model(pruned['tcfg'], device='cpu')
    model.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in ref:
        assert rel_l2(got[k].numpy(), np.asarray(ref[k])) <= 1e-4, k


def test_pruned_train_step_matches_jax(pruned):
    """One train step of the pruned model from the pruned weights, as
    fine-tuning takes it, on both sides."""
    jcfg, tcfg, tree = pruned['jcfg'], pruned['tcfg'], pruned['tree']
    batch = _batch(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        pruned['jmodel'], jcfg, tx,
        trainable=jstate.trainable_mask(state.params, 'all'))
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    tstep = make_train_step(model, tcfg, make_optimizer(tcfg),
                            trainable=trainable_mask(model, 'all'),
                            device='cpu')
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    tm = tstep(_torch_batch(batch))
    names_j, wj = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    names_t, wt = _flat(params_to_jax_layout(model.state_dict())['params'])
    assert names_j == names_t
    _, w0 = _flat(tree['params'])
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0) <= 1e-3
    for k, v in jm.items():
        assert abs(float(tm[k]) - float(v)) <= 1e-5 * abs(float(v)), k


# --------------------------------------------------------------------------
# the command line


def test_set_knobs_make_the_config_jax_makes(monkeypatch):
    """--set INNER_WIDTH_MULT / QUANT_BF16_STEM / QUANT_S8_JOIN set the
    knobs with no new flag. The JAX CLI takes the first two; its Config
    has no QUANT_S8_JOIN attribute (bench.py sets it directly), so its
    --set refuses that one, where the port's Config carries it."""
    import pose_estimator as jcli
    from ursonet_torch import pose_estimator as tcli
    monkeypatch.setattr(jax, 'devices', lambda *a: jax.local_devices()[:1])
    argv = ['evaluate', '--dataset', 'x', '--weights', 'none', '--int8',
            '--set', 'INNER_WIDTH_MULT=0.6', '--set', 'QUANT_BF16_STEM=True']
    want = jcli.make_config(jcli.build_parser().parse_args(argv))
    got = tcli.make_config(tcli.build_parser().parse_args(argv))
    for k in ('INNER_WIDTH_MULT', 'QUANT_BF16_STEM', 'BACKBONE'):
        assert getattr(got, k) == getattr(want, k), k
    argv += ['--set', 'QUANT_S8_JOIN=True']
    assert tcli.make_config(tcli.build_parser().parse_args(argv)) \
        .QUANT_S8_JOIN is True
    with pytest.raises(SystemExit, match='QUANT_S8_JOIN'):
        jcli.make_config(jcli.build_parser().parse_args(argv))


def test_knobs_through_the_command_line(tmp_path, capsys):
    """train, evaluate --int8, export --int8 and test of a pruned
    ResNet-50 under QUANT_S8_JOIN and QUANT_BF16_STEM, by --set alone;
    the exported artifact records the knobs."""
    from ursonet_torch import pose_estimator as tcli
    from ursonet_torch.checkpoint.quant_store import load_quantized
    from ursonet_torch.data.synthetic import make_urso_dataset
    data = str(tmp_path / 'datasets')
    make_urso_dataset(os.path.join(data, 'tiny'),
                      n_per_subset={'train': 2, 'val': 2, 'test': 2},
                      width=128, height=96, seed=1)
    knobs = ['--set', 'INNER_WIDTH_MULT=0.5', '--set', 'QUANT_S8_JOIN=True',
             '--set', 'QUANT_BF16_STEM=True']

    def args(command, *extra):
        return [command, '--dataset', 'tiny', '--data_dir', data, '--logs',
                str(tmp_path / 'logs'), '--out_dir', str(tmp_path / 'out'),
                '--models_dir', str(tmp_path / 'models'), '--backbone',
                'resnet50', '--bottleneck', '8', '--branch_size', '16',
                '--image_scale', '0.1', '--ori_resolution', '6',
                '--classify_ori', '--regress_loc'] + knobs + list(extra)

    assert tcli.main(args('train', '--weights', 'none', '--epochs', '1',
                          '--steps_per_epoch', '1', '--batch_size', '2',
                          '--set', 'VALIDATION_STEPS=1'), device='cpu') == 0
    run = glob.glob(str(tmp_path / 'logs' / 'tiny*'))[0]
    weights = store.load_weights_file(
        glob.glob(os.path.join(run, 'weights_tiny_*.msgpack'))[0])
    assert weights['backbone.res2a.res2a_branch2b.weight'].shape \
        == (32, 32, 3, 3)
    assert tcli.main(args('evaluate', '--weights', 'last', '--int8',
                          '--eval_batch', '2', '--bias_correct', '0'),
                     device='cpu') == 0
    assert 'ESA score' in capsys.readouterr().out
    assert tcli.main(args('export', '--weights', 'last', '--int8',
                          '--bias_correct', '0'), device='cpu') == 0
    capsys.readouterr()
    art = str(tmp_path / 'out' / 'tiny_int8.msgpack')
    cfg = tcli.make_config(tcli.build_parser().parse_args(
        args('evaluate', '--weights', 'none')))
    qm = load_quantized(art, cfg, device='cpu')
    assert qm._mcfg['s8_join'] and qm._mcfg['bf16_stem']
    assert qm.flat['res2a_branch2b'][0].shape == (3, 3, 32, 32)
    assert tcli.main(args('test', '--weights', 'last', '--eval_batch', '2'),
                     device='cpu') == 0
    assert glob.glob(str(tmp_path / 'out' / 'overlays' / '*.png'))
