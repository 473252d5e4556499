"""The space-to-depth stem of the port (QUANT_STEM_S2D, QUANT_HOST_S2D,
STEM_SPACE_TO_DEPTH; `stem_s8` and its plain version) against the JAX
package on the same inputs (numpy seeds), on the CPU.

Tolerances:
  * `space_to_depth2`, `stem_kernel_to_s2d`, `_host_s2d_maybe`: exact
    (reindexing);
  * `stem_s8_torch(mode='shift128')` against the Pallas stem kernel in
    interpret mode and against the probe's `reference_stem`: 0 differing
    elements;
  * `stem_s8_torch(mode='calibrated')` against the port's unfused route
    and against the JAX package's `Int8Ops` (input -> s2d conv -> relu ->
    maxpool): bit-exact;
  * the int8 model under QUANT_STEM_S2D and QUANT_HOST_S2D against the JAX
    package's: the orientation logits (the int8 body end to end)
    bit-exact, the float twin at relative L2 1e-5 (f32 convolutions
    summed in another order), the float model with STEM_SPACE_TO_DEPTH at
    1e-4.
"""

import importlib.util
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu import engine as jengine
from ursonet_tpu.models import quant as jq
from ursonet_tpu.models import resnet as jresnet
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_torch import presets
from ursonet_torch.checkpoint import quant_store as tqs
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models import quant as tq
from ursonet_torch.models import resnet as tresnet
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import int8_cuda as ic
from test_torch_model import jax_variables
from torch_parity import rel_l2, small_configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, 'tests', 'data', 'gate_int8.msgpack')
MEAN12 = np.tile(np.array([123.7, 116.8, 103.9], np.float32), 4)


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(seed, n=2, dim=64):
    return np.random.RandomState(seed).randint(
        0, 256, (n, dim, dim, 3)).astype(np.uint8)


def _s2d_np(x):
    b, h, w, c = x.shape
    return np.ascontiguousarray(
        x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    ).reshape(b, h // 2, w // 2, 4 * c)


# --------------------------------------------------------------------------
# reindexing


@pytest.mark.parametrize('shape', [(2, 8, 12, 3), (1, 64, 64, 3),
                                   (3, 2, 2, 5)])
def test_space_to_depth2_matches_jax(shape):
    x = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(jresnet.space_to_depth2(jnp.asarray(x)))
    got = tresnet.space_to_depth2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_s2d_np(x), want)
    with pytest.raises(ValueError):
        tresnet.space_to_depth2(torch.zeros(1, 3, 4, 3))


@pytest.mark.parametrize('c,o', [(3, 64), (1, 8)])
def test_stem_kernel_to_s2d_matches_jax(c, o):
    k = np.random.RandomState(1).randn(7, 7, c, o).astype(np.float32)
    want = jresnet.stem_kernel_to_s2d(k)
    got = tresnet.stem_kernel_to_s2d(k)
    assert got.shape == (4, 4, 4 * c, o) and got.dtype == k.dtype
    np.testing.assert_array_equal(got, want)
    # the rewrite moves values, so it commutes with the weight quantize
    k8, sw = tq.quantize_weight(k)
    r8, rsw = tq.quantize_weight(got)
    np.testing.assert_array_equal(r8, tresnet.stem_kernel_to_s2d(k8))
    np.testing.assert_array_equal(rsw, sw)
    with pytest.raises(ValueError):
        tresnet.stem_kernel_to_s2d(np.zeros((3, 3, 3, 8), np.float32))


def test_float_model_with_s2d_stem_matches_jax():
    """STEM_SPACE_TO_DEPTH: the float model built with the (4,4,12,64)
    stem, its kernel carried across by params_from_jax."""
    jcfg, tcfg = small_configs(STEM_SPACE_TO_DEPTH=True)
    jmodel = jax_build_model(jcfg)
    tree = jax_variables(jmodel, (2, 64, 64, 3), seed=2)
    assert tree['params']['backbone']['conv1']['kernel'].shape \
        == (4, 4, 12, 64)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32) * 50
    ref = jmodel.apply(tree, jnp.asarray(x), training=False)
    model = build_model(tcfg, device='cpu')
    sd = params_from_jax(tree)
    assert tuple(sd['backbone.conv1.weight'].shape) == (64, 12, 4, 4)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for k in ('loc', 'ori'):
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-4, k
    back = params_to_jax_layout(model.state_dict())
    np.testing.assert_array_equal(
        back['params']['backbone']['conv1']['kernel'],
        tree['params']['backbone']['conv1']['kernel'])
    # and it quantizes directly: the folded kernel is already in s2d form
    qm = tq.QuantizedModel.from_variables(tcfg, back['params'],
                                          back['batch_stats'], device='cpu')
    assert qm._mcfg['stem_s2d'] and not qm._mcfg['host_s2d']
    twin = qm.float_twin(x)
    for k in ('loc', 'ori'):
        assert rel_l2(twin[k].numpy(), ref[k]) <= 1e-4, k


# --------------------------------------------------------------------------
# stem_s8's plain version against the TPU kernel


def _stem_case(seed, b, h2, w2):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (b, h2, w2, 12)).astype(np.uint8)
    w8 = rng.randint(-127, 128, (192, 64)).astype(np.int8)
    sw = rng.uniform(0.001, 0.01, 64).astype(np.float32)
    bias = rng.uniform(-1, 1, 64).astype(np.float32)
    return x, w8, sw, bias


def test_stem_shift128_matches_pallas_stem():
    """The probe's check() shape (2 x 64 x 32 x 12): the Pallas kernel in
    interpret mode, the probe's reference and the port's plain version
    agree in every element."""
    probe = _probe('probe_pallas_stem')
    x, w8, sw, bias = _stem_case(0, 2, 64, 32)
    site_scale = 25.0
    alpha, beta = probe.make_epilogue(w8, sw, bias, MEAN12, site_scale)
    want = np.asarray(probe.reference_stem(
        jnp.asarray(x), jnp.asarray(w8), sw, bias, MEAN12, site_scale))
    pallas = np.asarray(probe.fused_stem(
        probe.pad_and_shift(jnp.asarray(x), jnp.asarray(MEAN12)),
        jnp.asarray(w8), jnp.asarray(alpha), jnp.asarray(beta), half=16,
        interpret=True))
    got = ic.stem_s8(torch.from_numpy(x),
                     ic.kernel_layout(w8.reshape(4, 4, 12, 64)),
                     torch.from_numpy(alpha), torch.from_numpy(beta),
                     inv_s_out=1.0, mode='shift128', mean=MEAN12).numpy()
    assert got.shape == want.shape == (2, 32, 16, 64)
    assert int((pallas != want).sum()) == 0
    assert int((got != want).sum()) == 0
    assert 0 < got.max() <= 127 and (got > 0).mean() > 0.2


@pytest.mark.parametrize('b,h2,w2', [(1, 20, 12), (2, 7, 9)])
def test_stem_shift128_matches_reference_at_sizes_the_tpu_kernel_refuses(
        b, h2, w2):
    """Heights that are no multiple of 32, and odd sizes (pool padding
    (1, 1)): still the probe's reference, element for element."""
    probe = _probe('probe_pallas_stem')
    x, w8, sw, bias = _stem_case(3, b, h2, w2)
    alpha, beta = probe.make_epilogue(w8, sw, bias, MEAN12, 30.0)
    want = np.asarray(probe.reference_stem(
        jnp.asarray(x), jnp.asarray(w8), sw, bias, MEAN12, 30.0))
    got = ic.stem_s8_torch(torch.from_numpy(x),
                           ic.kernel_layout(w8.reshape(4, 4, 12, 64)),
                           torch.from_numpy(alpha), torch.from_numpy(beta),
                           inv_s_out=1.0, mode='shift128', mean=MEAN12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stem_calibrated_matches_unfused_route_and_jax_int8ops():
    """mode='calibrated' is the serving model's stem section: equal to
    the port's unfused route (input quantize -> conv_s8 q8_relu ->
    maxpool) and to the JAX package's Int8Ops, bit for bit."""
    x, w8, sw, bias = _stem_case(4, 2, 16, 24)
    w4 = w8.reshape(4, 4, 12, 64)
    scales = {'input': 139.3, 'conv1/out': 21.7}
    # the JAX package
    jops = jq.Int8Ops({'conv1': (jnp.asarray(w4), jnp.asarray(sw),
                                 jnp.asarray(bias))}, {}, scales,
                      acc_dtype=jnp.float32, mean_pixel=MEAN12[:3])
    y = jops.conv(jops.input(jnp.asarray(x)), 'conv1', 1, [(2, 1), (2, 1)])
    want = np.asarray(jax.jit(
        lambda: jops.maxpool(jops.relu(y, 'conv1/out')).arr)())
    # the port, fused (plain version) and unfused
    q = {'conv1': (ic.kernel_layout(w4), torch.from_numpy(sw),
                   torch.from_numpy(bias))}
    tops = tq.Int8Ops(q, {}, scales, mean_pixel=MEAN12[:3], fused_stem=True)
    xt = torch.from_numpy(x)
    fused = tops.maxpool(tops.relu(
        tops.conv(tops.input(xt), 'conv1', 1, [(2, 1), (2, 1)]), 'conv1/out'))
    tops.fused_stem = False
    unfused = tops.maxpool(tops.relu(
        tops.conv(tops.input(xt), 'conv1', 1, [(2, 1), (2, 1)]), 'conv1/out'))
    assert fused.scale == unfused.scale == scales['conv1/out'] / 127.0
    np.testing.assert_array_equal(fused.arr.numpy(), unfused.arr.numpy())
    np.testing.assert_array_equal(fused.arr.numpy(), want)
    assert (want > 0).mean() > 0.2


def test_stem_input_modes():
    x = torch.tensor([[0, 128, 255, 124]], dtype=torch.uint8) \
        .repeat(1, 3)[None, None]
    q, fill = ic.stem_input_s8(x, 'shift128', MEAN12, 1.0)
    assert q.flatten()[:4].tolist() == [-128, 0, 127, -4]
    assert fill[:3].tolist() == [124 - 128, 117 - 128, 104 - 128]
    q, fill = ic.stem_input_s8(x, 'calibrated', MEAN12,
                               float(np.float32(1) / np.float32(1.09)))
    want = np.clip(np.round((x.numpy().astype(np.float32) - MEAN12)
                            * (np.float32(1) / np.float32(1.09))), -127, 127)
    np.testing.assert_array_equal(q.numpy(), want.astype(np.int8))
    assert not fill.any()
    with pytest.raises(ValueError):
        ic.stem_input_s8(x, 'bogus', MEAN12, 1.0)
    assert ic.pool_pads(8) == (0, 1) and ic.pool_pads(7) == (1, 1)


# --------------------------------------------------------------------------
# the int8 model


@pytest.fixture(scope='module')
def jax_pair():
    """The small config's JAX weights, and per variant the JAX
    QuantizedModel calibrated on uint8 images and smoothed."""
    out = {}
    for variant, knobs in (('base', {}),
                           ('s2d', dict(QUANT_STEM_S2D=True)),
                           ('host_s2d', dict(QUANT_STEM_S2D=True,
                                             QUANT_HOST_S2D=True))):
        jcfg, tcfg = small_configs(**knobs)
        if not out:
            out['tree'] = jax_variables(jax_build_model(jcfg),
                                        (2, 64, 64, 3), seed=5)
        qm = jq.QuantizedModel.from_variables(
            jcfg, out['tree']['params'], out['tree']['batch_stats'])
        x = _images(0)
        if variant == 'host_s2d':
            x = _s2d_np(x)
        qm.calibrate(jnp.asarray(x))
        qm.smooth(0.5)
        out[variant] = dict(qm=qm, jcfg=jcfg, tcfg=tcfg)
    return out


def _carried(pair):
    want = pair['qm']
    qm = tq.QuantizedModel(pair['tcfg'],
                           {k: (np.array(w), np.array(b))
                            for k, (w, b) in want.flat.items()}, device='cpu')
    qm.act_scales = dict(want.act_scales)
    return qm


@pytest.mark.parametrize('variant', ['s2d', 'host_s2d', 'base'])
@pytest.mark.parametrize('u8', [True, False])
def test_int8_forward_s2d_matches_jax(jax_pair, variant, u8):
    """uint8 pixels take the fused stem (the raw batch its 'nhwc' route
    under `base` and `s2d`), molded floats the unfused route: both the
    JAX package's bits."""
    pair = jax_pair[variant]
    x = _images(2)
    if not u8:
        x = x.astype(np.float32) - np.asarray(pair['tcfg'].MEAN_PIXEL,
                                              np.float32)
    if variant == 'host_s2d':
        x = _s2d_np(x)
    ref = {k: np.asarray(v) for k, v in pair['qm'](jnp.asarray(x)).items()}
    qm = _carried(pair)
    assert qm._mcfg == pair['qm']._mcfg
    assert qm._mcfg['stem_s2d'] == (variant != 'base') \
        and qm._mcfg['host_s2d'] == (variant == 'host_s2d')
    got = qm(x)
    for k in ref:
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-3, k
    np.testing.assert_array_equal(got['ori'].numpy(), ref['ori'])
    twin = qm.float_twin(x)
    for k, v in pair['qm'].float_twin(jnp.asarray(x)).items():
        assert rel_l2(twin[k].numpy(), v) <= 1e-5, k


def test_stem_s2d_rewrite_matches_standard(jax_pair):
    """QUANT_STEM_S2D rewrites the 7x7 stem at init; the float twin
    agrees with the un-rewritten twin to accumulation-order noise."""
    tree = jax_pair['tree']
    _, tcfg = small_configs(QUANT_STEM_S2D=True)
    qm_s2d = tq.QuantizedModel.from_variables(
        tcfg, tree['params'], tree['batch_stats'], device='cpu')
    assert qm_s2d._mcfg['stem_s2d'] and qm_s2d.flat['conv1'][0].shape \
        == (4, 4, 12, 64)
    _, tcfg = small_configs()
    qm_std = tq.QuantizedModel.from_variables(
        tcfg, tree['params'], tree['batch_stats'], device='cpu')
    assert not qm_std._mcfg['stem_s2d']
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32) * 60
    a, b = qm_s2d.float_twin(x), qm_std.float_twin(x)
    # outputs reach 150 and the f32 sums take another order through every
    # layer: 1e-4 relative, 1e-3 absolute
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-4,
                                   atol=1e-3)
        assert rel_l2(a[k].numpy(), b[k].numpy()) <= 1e-5, k
    # a QUANT_HOST_S2D without the s2d kernel has nothing to act on
    _, tcfg = small_configs(QUANT_HOST_S2D=True)
    assert not tq.QuantizedModel.from_variables(
        tcfg, tree['params'], tree['batch_stats'],
        device='cpu')._mcfg['host_s2d']


def test_host_s2d_matches_device_s2d(jax_pair):
    """Shipping the uint8 batch packed from the host gives the bits of
    the device-side reindex, and both those of the 7x7 stem."""
    tree = jax_pair['tree']
    u8 = _images(0)
    outs, qms = {}, {}
    for variant, knobs in (('base', {}), ('s2d', dict(QUANT_STEM_S2D=True)),
                           ('host_s2d', dict(QUANT_STEM_S2D=True,
                                             QUANT_HOST_S2D=True))):
        _, tcfg = small_configs(**knobs)
        qm = qms[variant] = tq.QuantizedModel.from_variables(
            tcfg, tree['params'], tree['batch_stats'], device='cpu')
        x = _s2d_np(u8) if variant == 'host_s2d' else u8
        qm.calibrate(x)
        outs[variant] = qm(x)
        if variant != 'base':
            plain = qm(x, plain=True)
            for k in plain:
                torch.testing.assert_close(plain[k], outs[variant][k],
                                           rtol=0, atol=0)
    for k in outs['s2d']:
        torch.testing.assert_close(outs['host_s2d'][k], outs['s2d'][k],
                                   rtol=0, atol=0)
    # against the 7x7 stem only the float twin's calibration differs (the
    # conv sums in another order): the steps agree to 1e-5, and on the
    # 7x7 model's steps the s2d variants give its bits (the rewrite is
    # exact in integers)
    base = qms['base'].act_scales
    for site, s in qms['s2d'].act_scales.items():
        assert abs(s - base[site]) <= 1e-5 * base[site], site
    qms['host_s2d'].act_scales = dict(base)
    again = qms['host_s2d'](_s2d_np(u8))
    for k in outs['base']:
        torch.testing.assert_close(again[k], outs['base'][k], rtol=0, atol=0)


def test_engine_host_s2d_reindex(jax_pair):
    """_host_s2d_maybe equals space_to_depth2 on numpy and on tensors and
    is a no-op without a host-s2d model or on a packed batch."""
    pair = jax_pair['host_s2d']
    eng = ServingEngine(pair['tcfg'], device='cpu')
    u8 = np.random.RandomState(1).randint(0, 256, (2, 8, 12, 3)) \
        .astype(np.uint8)
    assert eng._host_s2d_maybe(u8) is u8            # no int8 model yet
    eng.qmodel = _carried(pair)
    want = np.asarray(jresnet.space_to_depth2(jnp.asarray(u8)))
    got = eng._host_s2d_maybe(u8)
    assert isinstance(got, np.ndarray) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    t = eng._host_s2d_maybe(torch.from_numpy(u8))
    assert t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), want)
    assert eng._host_s2d_maybe(got) is got          # already packed
    eng.qmodel = _carried(jax_pair['s2d'])
    assert eng._host_s2d_maybe(u8) is u8            # the device packs


def test_predict_molded_host_s2d_matches_jax_engine(jax_pair):
    """ServingEngine.predict_molded in host-s2d mode against the JAX
    engine's: molded floats ship as uint8, are packed on the host and
    serve through the fused stem."""
    pair = jax_pair['host_s2d']
    jcfg, tcfg, jqm = pair['jcfg'], pair['tcfg'], pair['qm']
    rng = np.random.RandomState(9)
    molded = (rng.uniform(0, 255, (2, 64, 64, 3))
              - np.asarray(tcfg.MEAN_PIXEL)).astype(np.float32)
    fake = SimpleNamespace(state=object(), config=jcfg, _qmodel=jqm,
                           mesh=SimpleNamespace(size=1))
    fake._host_s2d_maybe = lambda m: jengine.UrsoNet._host_s2d_maybe(fake, m)
    want = {k: np.asarray(v) for k, v in
            jengine.UrsoNet.predict_molded(fake, molded).items()}
    eng = ServingEngine(tcfg, device='cpu')
    eng.qmodel = _carried(pair)
    ic.reset_counts()
    got = eng.predict_molded(molded)
    assert ic.launches['stem_s8'] == 0      # the CPU runs the plain version
    for k in want:
        assert rel_l2(got[k].numpy(), want[k]) <= 1e-3, k
    np.testing.assert_array_equal(got['ori'].numpy(), want['ori'])
    # tensors take the same path
    again = eng.predict_molded(torch.from_numpy(molded))
    for k in got:
        torch.testing.assert_close(again[k], got[k], rtol=0, atol=0)


def test_quantize_calibrates_on_packed_images():
    """ServingEngine.quantize() under host_s2d calibrates on the packed
    batch; the scales are those of the device-s2d engine."""
    imgs = list(_images(6))
    scales = {}
    for variant in ('s2d', 'host_s2d'):
        cfg = presets.serving_config(batch=2, variant=variant)
        cfg.IMAGE_RESIZE_MODE = 'square'
        cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
        cfg.BRANCH_SIZE, cfg.BOTTLENECK_WIDTH, cfg.ORI_BINS_PER_DIM = 32, 16, 6
        cfg.update()
        eng = ServingEngine(cfg, 'cpu',
                            generator=torch.Generator().manual_seed(0))
        qm = eng.quantize(imgs)
        assert qm._mcfg['host_s2d'] == (variant == 'host_s2d')
        scales[variant] = qm.act_scales
        out = eng.predict_molded(np.stack(imgs))
        assert all(torch.isfinite(v).all() for v in out.values())
    assert scales['s2d'] == scales['host_s2d']
    with pytest.raises(ValueError):
        presets.serving_config(variant='bf16_stem')
    base = presets.serving_config()
    assert not base.QUANT_STEM_S2D and not base.QUANT_HOST_S2D


# --------------------------------------------------------------------------
# artifacts


def test_s2d_artifact_loads_and_serves_as_the_7x7_one(tmp_path):
    """The committed artifact with its stem kernel rewritten to s2d form
    (in memory, then written by flax as save_quantized would) loads, its
    mcfg knobs are not checked against the config, and at 128 x 128 it
    serves the bits of the 7x7 artifact: the rewrite is exact in
    integers."""
    from flax import serialization
    with open(ARTIFACT, 'rb') as f:
        tree = serialization.msgpack_restore(f.read())
    node = tree['flat']['conv1']
    node['kernel_q'] = tresnet.stem_kernel_to_s2d(node['kernel_q'])
    tree['mcfg'] = dict(tree['mcfg'], stem_s2d=True, host_s2d=True)
    path = tmp_path / 's2d.msgpack'
    path.write_bytes(serialization.msgpack_serialize(tree))

    def cfg_for(variant):
        cfg = presets.serving_config(batch=1, variant=variant)
        cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 128
        cfg.update()
        return cfg

    # the dense heads are laid out for 512x640 features; serve the conv
    # body at 128x128 through the twin's backbone only
    x = np.random.RandomState(0).randint(0, 256, (1, 128, 128, 3)) \
        .astype(np.uint8)
    outs = {}
    for variant, p in (('base', ARTIFACT), ('host_s2d', str(path)),
                       ('s2d', str(path))):
        qm = tqs.load_quantized(p, cfg_for(variant), device='cpu')
        assert qm._mcfg['stem_s2d'] == (variant != 'base')
        assert qm._mcfg['host_s2d'] == (variant == 'host_s2d')
        ops = tq.Int8Ops(qm._prepared_q(), {}, qm.act_scales,
                         mean_pixel=qm._mcfg['mean_pixel'],
                         fused_stem=qm._mcfg['stem_s2d'])
        xi = torch.from_numpy(_s2d_np(x) if variant == 'host_s2d' else x)
        y = tq._bottleneck_backbone(ops, ops.input(xi), qm._mcfg)
        outs[variant] = y.arr.numpy()
    assert outs['base'].shape == (1, 4, 4, 2048) and outs['base'].any()
    np.testing.assert_array_equal(outs['host_s2d'], outs['base'])
    np.testing.assert_array_equal(outs['s2d'], outs['base'])
    # the JAX package loads the same file and derives the same knobs
    from ursonet_tpu.checkpoint import quant_store as jqs
    from test_torch_quant import _jax_gate_config
    jcfg = _jax_gate_config()
    jcfg.QUANT_STEM_S2D = jcfg.QUANT_HOST_S2D = True
    jqm = jqs.load_quantized(str(path), jcfg)
    got = tqs.load_quantized(str(path),
                             presets.serving_config(variant='host_s2d'),
                             device='cpu')
    assert got._mcfg == jqm._mcfg
    np.testing.assert_array_equal(got.flat['conv1'][0], jqm.flat['conv1'][0])
