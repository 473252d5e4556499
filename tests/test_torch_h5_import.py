"""The port's Keras-h5 bridge (`ursonet_torch/checkpoint/h5_import.py`,
on the port's HDF5 codec) against the JAX package's (on h5py), in both
directions, on seeded small models (ResNet-50, 64×64).

Tolerances: weights moved through a file are compared exactly; the
forward of loaded weights within a relative L2 error of 1e-4 of the JAX
forward (the bound of tests/test_torch_model.py: convolutions summed in
another order by another library); reports and file lookups equal.
"""

import os
import re
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu.checkpoint import h5_import as jh5
from ursonet_tpu.models.resnet import stem_kernel_to_s2d as jax_stem_to_s2d
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_torch.checkpoint import h5_import as th5
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.engine import UrsoNet
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.state import layer_name_of
from test_torch_model import jax_variables
from torch_parity import rel_l2, small_configs

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))

torch.set_num_threads(1)

FWD_TOL = 1e-4


def _x(cfg, seed=1):
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    return np.random.RandomState(seed).randn(2, h, w, 3).astype(
        np.float32) * 50


def _jax_forward(jmodel, tree, x):
    return jmodel.apply(tree, jnp.asarray(x), training=False)


def _port_forward(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _names(values):
    return [v.decode() if isinstance(v, bytes) else str(v) for v in values]


def _assert_trees_equal(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg='/'.join(k))


@pytest.fixture(scope='module')
def jax_side():
    jcfg, tcfg = small_configs()
    jmodel = jax_build_model(jcfg)
    h, w = int(jcfg.IMAGE_SHAPE[0]), int(jcfg.IMAGE_SHAPE[1])
    tree = jax_variables(jmodel, (2, h, w, 3), seed=3)
    return jcfg, tcfg, jmodel, tree


def test_jax_file_loads_into_the_port(jax_side, tmp_path):
    jcfg, tcfg, jmodel, tree = jax_side
    path = str(tmp_path / 'jax.h5')
    jh5.save_keras_h5(path, tree['params'], tree['batch_stats'])
    engine = UrsoNet('inference', tcfg, str(tmp_path / 'logs'), device='cpu')
    engine.initialize(seed=11)            # other weights than the file's
    engine.load_weights(path)
    got = engine.model.state_dict()
    want = params_from_jax(tree)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = _x(tcfg)
    ref, out = _jax_forward(jmodel, tree, x), _port_forward(engine.model, x)
    for k in ('loc', 'ori'):
        assert rel_l2(out[k].numpy(), ref[k]) <= FWD_TOL, k


def test_port_file_loads_into_jax(jax_side, tmp_path):
    jcfg, tcfg, jmodel, tree = jax_side
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(5))
    path = str(tmp_path / 'port.h5')
    th5.save_keras_h5(path, model.state_dict())
    params, stats, report = jh5.load_keras_h5(
        path, tree['params'], tree['batch_stats'])
    want = params_to_jax_layout(model.state_dict())
    _assert_trees_equal({'params': params, 'batch_stats': stats}, want)
    _, port_report = th5.load_keras_h5(path, model.state_dict())
    assert port_report == report
    assert not report['unmatched'] and not report['mismatched']
    x = _x(tcfg)
    ref = _jax_forward(jmodel, {'params': params, 'batch_stats': stats}, x)
    out = _port_forward(model, x)
    for k in ('loc', 'ori'):
        assert rel_l2(out[k].numpy(), ref[k]) <= FWD_TOL, k
    # both writers lay out the same names and values
    jpath = str(tmp_path / 'jax.h5')
    jh5.save_keras_h5(jpath, want['params'], want['batch_stats'])
    with h5py.File(jpath, 'r') as a, h5py.File(path, 'r') as b:
        # h5py keeps a list of bytes as variable-length strings, the port
        # as fixed-length ones: the same names
        assert _names(a.attrs['layer_names']) == \
            _names(b.attrs['layer_names'])
        for lname in a:
            wnames = _names(a[lname].attrs['weight_names'])
            assert wnames == _names(b[lname].attrs['weight_names'])
            for w in wnames:
                np.testing.assert_array_equal(a[lname][w][()],
                                              b[lname][w][()])


def test_reports_match_jax(jax_side, tmp_path):
    """Exclusion, unmatched layers and leaves and shape mismatches, in
    the JAX package's order."""
    jcfg, tcfg, jmodel, tree = jax_side
    path = str(tmp_path / 'mixed.h5')
    jh5.save_keras_h5(path, tree['params'], tree['batch_stats'])
    rng = np.random.RandomState(2)
    with h5py.File(path, 'a') as f:
        names = _names(f.attrs['layer_names'])
        g = f.create_group('mrcnn_mask')        # not in the model
        g.create_dataset('mrcnn_mask/kernel:0', data=rng.randn(1, 1, 2, 2)
                         .astype(np.float32))
        g.attrs['weight_names'] = [b'mrcnn_mask/kernel:0']
        del f['ori_final']                     # another shape
        g = f.create_group('ori_final')
        g.create_dataset('ori_final/kernel:0', data=np.zeros((3, 5),
                                                              np.float32))
        g.create_dataset('ori_final/extra:0', data=np.zeros(5, np.float32))
        g.attrs['weight_names'] = [b'ori_final/kernel:0', b'ori_final/extra:0']
        f.attrs['layer_names'] = [n.encode() for n in
                                  ['mrcnn_mask'] + names]
    exclude = ['res2.*', 'bn2a_branch1', 'loc_.*']
    _, _, want = jh5.load_keras_h5(path, tree['params'], tree['batch_stats'],
                                   exclude=exclude)
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd, got = th5.load_keras_h5(path, model.state_dict(), exclude=exclude)
    assert got == want
    assert want['excluded'] and want['mismatched'] == ['ori_final/kernel']
    assert 'mrcnn_mask/kernel' in want['unmatched']
    assert 'ori_final/extra' in want['unmatched']
    # excluded and mismatched layers keep their weights
    kept = 0
    for k in sd:
        layer = layer_name_of(k)
        if layer == 'ori_final' or any(re.fullmatch(p, layer)
                                       for p in exclude):
            assert torch.equal(sd[k], before[k]), k
            kept += 1
    assert kept > 10
    assert not torch.equal(sd['backbone.conv1.weight'],
                           before['backbone.conv1.weight'])


def test_stem_7x7_loads_into_s2d_exactly(jax_side, tmp_path):
    jcfg, tcfg, jmodel, tree = jax_side
    path = str(tmp_path / 'ref_stem.h5')
    jh5.save_keras_h5(path, tree['params'], tree['batch_stats'])
    js2d, ts2d = small_configs(STEM_SPACE_TO_DEPTH=True)
    model = build_model(ts2d, 'cpu', torch.Generator().manual_seed(0))
    sd, report = th5.load_keras_h5(path, model.state_dict())
    assert 'conv1/kernel' in report['loaded'] and not report['mismatched']
    k7 = tree['params']['backbone']['conv1']['kernel']
    want = jax_stem_to_s2d(np.asarray(k7))                 # (4,4,12,64)
    got = sd['backbone.conv1.weight'].numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(got, want)
    jtree = jax_variables(jax_build_model(js2d), (2, 64, 64, 3))
    jparams, _, jreport = jh5.load_keras_h5(path, jtree['params'],
                                            jtree['batch_stats'])
    np.testing.assert_array_equal(
        got, np.asarray(jparams['backbone']['conv1']['kernel']))
    assert jreport == report
    model.load_state_dict(sd)
    x = _x(ts2d)
    ref, out = _jax_forward(jmodel, tree, x), _port_forward(model, x)
    for k in ('loc', 'ori'):
        assert rel_l2(out[k].numpy(), ref[k]) <= FWD_TOL, k


def test_released_configs_and_files_match_jax(tmp_path):
    from verify_artifacts import _md5
    _, cfg = small_configs()
    cases = [dict(BACKBONE='resnet50', BOTTLENECK_WIDTH=128,
                  ORI_BINS_PER_DIM=24, REGRESS_ORI=False),
             dict(BACKBONE='resnet101', BOTTLENECK_WIDTH=528,
                  ORI_BINS_PER_DIM=32, REGRESS_ORI=False),
             dict(BACKBONE='resnet101', BOTTLENECK_WIDTH=128,
                  ORI_BINS_PER_DIM=24, REGRESS_ORI=False),
             dict(BACKBONE='resnet50', BOTTLENECK_WIDTH=128,
                  ORI_BINS_PER_DIM=24, REGRESS_ORI=True)]
    for case in cases:
        for k, v in case.items():
            setattr(cfg, k, v)
        for name in list(jh5.RELEASED_CONFIGS) + ['imagenet', 'bogus']:
            assert th5.check_released_config(name, cfg) == \
                jh5.check_released_config(name, cfg), (name, case)
    assert th5.RELEASED_CONFIGS == jh5.RELEASED_CONFIGS
    assert th5.RELEASED_FILES == jh5.RELEASED_FILES
    keys = list(jh5.RELEASED_FILES) + ['imagenet_resnet152', 'other']
    empty = str(tmp_path / 'empty')
    os.makedirs(empty)
    for key in keys:
        assert th5.find_released_file(empty, key) is None
        assert jh5.find_released_file(empty, key) is None
    # canonical names in one dir, the short aliases in another
    canon, alias = str(tmp_path / 'canon'), str(tmp_path / 'alias')
    os.makedirs(canon)
    os.makedirs(alias)
    for i, (key, (fn, _)) in enumerate(jh5.RELEASED_FILES.items()):
        with open(os.path.join(canon, fn), 'wb') as f:
            f.write(b'not the released weights %d' % i)
        short = f'{key}.h5' if key.startswith('imagenet_') else \
            f'ursonet_{key}.h5'
        with open(os.path.join(alias, short), 'wb') as f:
            f.write(b'alias %d' % i)
    for d in (canon, alias):
        for key in keys:
            got = th5.find_released_file(d, key)
            assert got == jh5.find_released_file(d, key), (d, key)
            if got is None:
                continue
            pinned = jh5.RELEASED_FILES.get(key, (None, None))[1]
            assert th5.file_md5(got) == _md5(got)
            # verify_artifacts.py says 'BAD MD5' exactly where the port
            # reports a mismatch
            bad = bool(pinned) and _md5(got) != pinned
            assert (th5.released_md5_error(key, got) is not None) == bad
            assert bad == bool(pinned)
