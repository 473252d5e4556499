"""The port's int8 PTQ serving model (`ursonet_torch/models/quant.py`,
`checkpoint/quant_store.py`) against the JAX package's
(`ursonet_tpu/models/quant.py`, `checkpoint/quant_store.py`) on the small
flagship-like configuration, with the same weights and inputs (numpy
seeds). One JAX QuantizedModel (calibrated, smoothed, bias-corrected) is
shared by the module.

Tolerances:
  * float twin: relative L2 1e-5 (f32 convolutions summed in another
    order by another library);
  * calibrated scales and channel maxima: rtol 1e-5 (max|x| of those
    f32 activations);
  * smooth(): rtol 1e-6 on the migrated weights from the same statistics
    (the same numpy arithmetic);
  * int8 forward with JAX's calibrated, smoothed and bias-corrected
    weights and scales: relative L2 1e-3, and the orientation logits (the
    int8 body end to end) bit-exact. The port's epilogues round as XLA's
    compiled ones do; only the location head's f32 final dense reorders;
  * artifact loading: every leaf equal.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu.checkpoint import quant_store as jqs
from ursonet_tpu.models import quant as jq
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_torch import presets
from ursonet_torch.checkpoint import quant_store as tqs
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models import quant as tq
from ursonet_torch.models.ursonet import build_model
from test_torch_model import jax_variables
from torch_parity import rel_l2, small_configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, 'tests', 'data', 'gate_int8.msgpack')
GOLDEN = os.path.join(ROOT, 'tests', 'data', 'gate_golden.npz')


def _images(seed, n=2, dim=64):
    return np.random.RandomState(seed).randint(
        0, 256, (n, dim, dim, 3)).astype(np.uint8)


@pytest.fixture(scope='module')
def jax_qm():
    """JAX QuantizedModel of the small config: random weights with
    random BN, calibrated on uint8 images, smoothed, bias-corrected.
    Snapshots of each stage for the port's tests."""
    jcfg, tcfg = small_configs()
    tree = jax_variables(jax_build_model(jcfg), (2, 64, 64, 3), seed=5)
    qm = jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                          tree['batch_stats'])
    x = _images(0)
    flat0 = {k: (np.array(w), np.array(b)) for k, (w, b) in qm.flat.items()}
    qm.calibrate(jnp.asarray(x))
    calib = (dict(qm.act_scales),
             {k: np.array(v) for k, v in qm.chan_max.items()})
    qm.smooth(0.5)
    qm.bias_correct(jnp.asarray(x), passes=1)
    return dict(qm=qm, tree=tree, x=x, flat0=flat0, calib=calib, jcfg=jcfg,
                tcfg=tcfg)


def _port_qm(j, flat=None):
    return tq.QuantizedModel(j['tcfg'], flat or j['flat0'], device='cpu')


def test_flatten_folded_matches_jax(jax_qm):
    tree = jax_qm['tree']
    flat = tq.flatten_folded(tree['params'], tree['batch_stats'],
                             jax_qm['tcfg'])
    assert set(flat) == set(jax_qm['flat0'])
    for site, (w, b) in jax_qm['flat0'].items():
        np.testing.assert_allclose(flat[site][0], w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(flat[site][1], b, rtol=1e-6, atol=1e-7)


def test_from_port_model_matches_jax_flat(jax_qm):
    """The port's model, loaded with the JAX weights, gives the same
    folded sites through params_to_jax_layout."""
    model = build_model(jax_qm['tcfg'], device='cpu')
    model.load_state_dict(params_from_jax(jax_qm['tree']))
    t = params_to_jax_layout(model.state_dict())
    qm = tq.QuantizedModel.from_variables(jax_qm['tcfg'], t['params'],
                                          t['batch_stats'], device='cpu')
    for site, (w, b) in jax_qm['flat0'].items():
        np.testing.assert_allclose(qm.flat[site][0], w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(qm.flat[site][1], b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('shape', [(3, 3, 16, 8), (7, 7, 3, 64), (40, 13)])
def test_quantize_weight_bit_identical(shape):
    w = np.random.RandomState(1).randn(*shape).astype(np.float32)
    w8, sw = tq.quantize_weight(w)
    j8, jsw = jq.quantize_weight(w)
    np.testing.assert_array_equal(w8, j8)
    np.testing.assert_array_equal(sw, jsw)
    # the artifact round trip: re-quantizing w8 * sw gives w8 back
    r8, rsw = tq.quantize_weight(w8.astype(np.float32) * sw)
    np.testing.assert_array_equal(r8, w8)
    np.testing.assert_array_equal(rsw, sw)


@pytest.mark.parametrize('u8', [True, False])
def test_float_twin_matches_jax(jax_qm, u8):
    x = _images(1)
    if not u8:
        x = x.astype(np.float32) - np.asarray(
            jax_qm['tcfg'].MEAN_PIXEL, np.float32)
    ref = jq.QuantizedModel(jax_qm['jcfg'], jax_qm['flat0']).float_twin(
        jnp.asarray(x))
    got = _port_qm(jax_qm).float_twin(x)
    assert set(got) == set(ref)
    for k in ref:
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-5, k


def test_calibrate_matches_jax(jax_qm):
    qm = _port_qm(jax_qm)
    scales = qm.calibrate(jax_qm['x'])
    want_scales, want_chan = jax_qm['calib']
    assert set(scales) == set(want_scales)
    assert len(scales) == 56     # 16 blocks, as the flagship
    for k, v in want_scales.items():
        np.testing.assert_allclose(scales[k], v, rtol=1e-5, err_msg=k)
    # per-channel maxima at rtol 1e-5 of the site's maximum: a channel
    # whose dense output cancels to ~1% of the site's range carries the
    # f32 reordering at ~1e-4 of its own value (measured 1.2e-4 on
    # ori_dense_0, 8.7e-7 of that site's maximum)
    for k, v in want_chan.items():
        np.testing.assert_allclose(qm.chan_max[k], v, rtol=1e-5,
                                   atol=1e-5 * float(v.max()), err_msg=k)


def test_smooth_matches_jax(jax_qm):
    """smooth() from JAX's calibration statistics gives JAX's migrated
    weights and scales."""
    qm = _port_qm(jax_qm)
    scales, chan = jax_qm['calib']
    qm.act_scales = dict(scales)
    qm.chan_max = {k: v.copy() for k, v in chan.items()}
    qm.smooth(0.5)
    want = jax_qm['qm']
    assert set(qm.flat) == set(want.flat)
    for site, (w, b) in want.flat.items():
        np.testing.assert_allclose(qm.flat[site][0], w, rtol=1e-6, atol=0,
                                   err_msg=site)
        np.testing.assert_allclose(qm.flat[site][1], b, rtol=1e-6, atol=0,
                                   err_msg=site)
    for k, v in want.act_scales.items():
        np.testing.assert_allclose(qm.act_scales[k], v, rtol=1e-6, err_msg=k)


def _carried(jax_qm):
    """The port's model carrying JAX's calibrated, smoothed and
    bias-corrected state."""
    want = jax_qm['qm']
    qm = _port_qm(jax_qm, flat={k: (np.array(w), np.array(b))
                                for k, (w, b) in want.flat.items()})
    qm.act_scales = dict(want.act_scales)
    qm.bias_delta = {k: np.array(v) for k, v in want.bias_delta.items()}
    return qm


@pytest.mark.parametrize('u8', [True, False])
def test_int8_forward_matches_jax(jax_qm, u8):
    x = _images(2)
    if not u8:
        x = x.astype(np.float32) - np.asarray(
            jax_qm['tcfg'].MEAN_PIXEL, np.float32)
    ref = {k: np.asarray(v) for k, v in jax_qm['qm'](jnp.asarray(x)).items()}
    qm = _carried(jax_qm)
    assert qm.bias_delta, 'bias_correct left no deltas to carry'
    got = qm(x)
    plain = qm(x, plain=True)
    for k in ref:
        assert got[k].shape == ref[k].shape
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-3, k
        torch.testing.assert_close(plain[k], got[k], rtol=0, atol=0)
    np.testing.assert_array_equal(got['ori'].numpy(), ref['ori'])


def test_int8_close_to_float_twin(jax_qm):
    qm = _carried(jax_qm)
    x = _images(3)
    f, q = qm.float_twin(x), qm(x)
    for k in f:
        assert rel_l2(q[k].numpy(), f[k].numpy()) < tq.RANDOM_INIT_GATE_REL


def test_requires_calibration_and_refuses_unported(jax_qm):
    qm = _port_qm(jax_qm)
    with pytest.raises(RuntimeError):
        qm(_images(0))
    with pytest.raises(RuntimeError):
        qm.smooth()
    with pytest.raises(NotImplementedError):
        qm.bias_correct(_images(0))
    with pytest.raises(NotImplementedError):
        qm.shard_over(None)
    for knob in ('F16', 'QUANT_S8_JOIN', 'QUANT_BF16_STEM', 'QUANT_STEM_S2D',
                 'QUANT_HOST_S2D'):
        _, cfg = small_configs(**{knob: True})
        with pytest.raises(NotImplementedError, match=knob):
            tq.QuantizedModel(cfg, jax_qm['flat0'], device='cpu')
    _, cfg = small_configs(BACKBONE='resnet18')
    with pytest.raises(NotImplementedError):
        tq.QuantizedModel(cfg, jax_qm['flat0'], device='cpu')


def test_groups_and_float_sites_match_jax(jax_qm):
    for mcfg in (jax_qm['qm']._mcfg,
                 dict(jax_qm['qm']._mcfg, regress_loc=False,
                      float_cls_final=True),
                 dict(jax_qm['qm']._mcfg, backbone='resnet101',
                      nr_dense_layers=2, float_reg_head=True)):
        assert tq.float_sites(mcfg) == jq.float_sites(mcfg)
        assert tq.migration_groups(mcfg) == jq.migration_groups(mcfg)


# --------------------------------------------------------------------------
# the committed flagship artifact


def _jax_gate_config():
    spec = importlib.util.spec_from_file_location(
        'make_gate_artifact', os.path.join(ROOT, 'tools',
                                           'make_gate_artifact.py'))
    mga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mga)
    return mga.config_for_golden(np.load(GOLDEN))


def _leaves_equal(a, b, path=''):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _leaves_equal(a[k], b[k], f'{path}/{k}')
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_msgpack_decoder_matches_flax():
    from flax import serialization
    with open(ARTIFACT, 'rb') as f:
        data = f.read()
    _leaves_equal(tqs.msgpack_restore(data),
                  serialization.msgpack_restore(data))


def test_msgpack_decoder_wire_formats():
    """Every type byte flax can write, including the chunked arrays
    flax uses for leaves over 1 GiB (forced small here)."""
    import msgpack
    from flax import serialization
    tree = {'i': [0, 1, 127, 128, 65536, 2 ** 40, -1, -33, -200, -70000,
                  -2 ** 40], 'f': 1.5, 's': 'x' * 40, 'n': None, 't': True,
            'b': b'\x00\x01', 'big': 'y' * 70000,
            'arr': np.arange(12, dtype=np.int16).reshape(3, 4),
            'f16': np.ones((2,), np.float16), 'sc': np.float32(2.5),
            'list': list(range(20)), 'm': {str(i): i for i in range(20)}}
    data = serialization.msgpack_serialize(tree)
    _leaves_equal(tqs.msgpack_restore(data),
                  serialization.msgpack_restore(data))
    chunked = serialization._chunk(np.arange(10, dtype=np.float32))
    data = msgpack.packb({'c': chunked},
                         default=serialization._msgpack_ext_pack,
                         strict_types=True)
    np.testing.assert_array_equal(tqs.msgpack_restore(data)['c'],
                                  np.arange(10, dtype=np.float32))
    with pytest.raises(ValueError):
        tqs.msgpack_restore(data + b'\x00')


def test_load_quantized_matches_jax():
    want = jqs.load_quantized(ARTIFACT, _jax_gate_config())
    got = tqs.load_quantized(ARTIFACT, presets.serving_config(), device='cpu')
    assert got._mcfg == {k: v for k, v in want._mcfg.items()}
    assert got.act_scales == want.act_scales
    assert got.bias_delta.keys() == want.bias_delta.keys()
    for k, v in want.bias_delta.items():
        np.testing.assert_array_equal(got.bias_delta[k], v)
    assert got.flat.keys() == want.flat.keys()
    for site, (w, b) in want.flat.items():
        np.testing.assert_array_equal(got.flat[site][0], w, err_msg=site)
        np.testing.assert_array_equal(got.flat[site][1], b, err_msg=site)
    # the int8 weights the port serves are the stored ones
    w8, _ = tq.quantize_weight(got.flat['res3a_branch2b'][0])
    stored = tqs.msgpack_restore(open(ARTIFACT, 'rb').read())
    np.testing.assert_array_equal(
        w8, stored['flat']['res3a_branch2b']['kernel_q'])


def test_load_quantized_checks_the_config():
    cfg = presets.serving_config()
    cfg.ORI_BINS_PER_DIM = 16
    with pytest.raises(ValueError, match='ori_bins'):
        tqs.load_quantized(ARTIFACT, cfg, device='cpu')
    tqs.check_mcfg({'float_cls_final': False, 'stem_s2d': False},
                   presets.serving_config())
    with pytest.raises(ValueError, match='no'):
        tqs.check_mcfg({'backbone': 'resnet50'}, object())


def test_serving_config_is_the_benched_one():
    cfg = presets.serving_config()
    jcfg = _jax_gate_config()
    for k in ('BACKBONE', 'BOTTLENECK_WIDTH', 'BRANCH_SIZE', 'NR_DENSE_LAYERS',
              'REGRESS_LOC', 'REGRESS_ORI', 'ORI_BINS_PER_DIM',
              'IMAGE_RESIZE_MODE', 'IMAGE_MIN_DIM', 'IMAGE_MAX_DIM',
              'ORIENTATION_PARAM', 'LOC_BINS_PER_DIM', 'INT8_U8_INPUT',
              'QUANT_STEM_S2D', 'QUANT_HOST_S2D', 'QUANT_BF16_STEM',
              'QUANT_S8_JOIN', 'QUANT_FLOAT_CLS_FINAL',
              'QUANT_FLOAT_REG_HEAD'):
        assert getattr(cfg, k) == getattr(jcfg, k, False), k
    assert tuple(cfg.IMAGE_SHAPE) == (512, 640, 3)
    assert cfg.BATCH_SIZE == 128 and cfg.F16 is False
    assert cfg.head_input_features() == 10240


def test_artifact_serves_as_jax_does():
    """The committed flagship artifact at full width (512×640) on one
    golden image, served by the JAX package (F16 False: the f32
    epilogue) and by the port on the CPU: the orientation logits
    bit-exact, the location within the f32 final dense's reordering."""
    jcfg = _jax_gate_config()
    jcfg.F16 = False
    x = np.load(GOLDEN)['golden_in'][:1]
    want = {k: np.asarray(v) for k, v in
            jqs.load_quantized(ARTIFACT, jcfg)(jnp.asarray(x)).items()}
    got = tqs.load_quantized(ARTIFACT, presets.serving_config(batch=1),
                             device='cpu')(x)
    np.testing.assert_array_equal(got['ori'].numpy(), want['ori'])
    assert rel_l2(got['loc'].numpy(), want['loc']) <= 1e-6


@pytest.mark.parametrize('knobs', [dict(QUANT_FLOAT_CLS_FINAL=True),
                                   dict(QUANT_FLOAT_REG_HEAD=True),
                                   dict(REGRESS_ORI=True)])
def test_head_variants_match_jax(knobs):
    """The head variants the twin serves beside the flagship's: float
    classification finals, float metric-regression heads, and a
    quaternion regression head (l2norm final). JAX's calibration is
    carried over; the int8 body is bit-exact, so the outputs agree to
    the float heads' reordering."""
    jcfg, tcfg = small_configs(**knobs)
    tree = jax_variables(jax_build_model(jcfg), (2, 64, 64, 3), seed=6)
    jqm = jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                           tree['batch_stats'])
    jqm.calibrate(jnp.asarray(_images(4)))
    qm = tq.QuantizedModel(tcfg, jqm.flat, device='cpu')
    qm.act_scales = dict(jqm.act_scales)
    assert qm._mcfg == jqm._mcfg
    x = _images(5)
    want = {k: np.asarray(v) for k, v in jqm(jnp.asarray(x)).items()}
    got = qm(x)
    for k in want:
        assert rel_l2(got[k].numpy(), want[k]) <= 1e-5, k
