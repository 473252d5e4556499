"""F16 serving of the port (the JAX package's `config.F16`: bf16
epilogues in the int8 model, bf16 compute in the float model) against the
JAX package on the same inputs (numpy seeds), on the CPU. The JAX side is
`Int8Ops(acc_dtype=bfloat16)` compiled by XLA, what `bench.py` times: no
Pallas kernel of the repo has a bf16 epilogue.

Tolerances:
  * the bf16 epilogues (conv, dense and residual-join sites, accumulators
    above 2^24): bit-exact;
  * the int8 model with JAX's calibrated, smoothed and bias-corrected
    state carried over, in the `base`, `s2d` and `host_s2d` stems and on
    the committed artifact: the orientation logits (the int8 body end to
    end) bit-exact, `loc` within relative L2 1e-2 (its final dense is a
    bf16 product summed in another order; measured 0 on the small
    configuration);
  * the port's own bias_correct under F16: every site's delta within
    5e-3 of that site's largest |delta| plus 1e-3 (the per-channel means
    are f32 sums in another order; measured at most 4.3e-4 apart, on
    activations whose steps are 0.02 and up). In both modes, the port's
    deltas and JAX's each leave every site's per-channel mean error within
    the f32 sums' rounding (2e-6 of the largest mean, plus 1e-5) and,
    under F16, a bf16 ulp of the bias;
  * the bf16 float forward against the JAX model's F16 `apply` (op by
    op): the first residual block's output equal but for 1% of its
    elements (measured 0.17%: a bf16 rounding flipped by an f32 sum in
    another order), the heads within relative L2 3e-2 a head (those flips
    grown through sixteen blocks; measured 1.8% on `loc` and 1.1% on
    `ori`, where the JAX package's own jitted and op-by-op bf16 forwards
    of these random models differ by 1.2-4.1%: XLA keeps some sums in
    f32 under jit).
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
from ursonet_torch.checkpoint.convert import params_from_jax
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models import quant as tq
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import int8_cuda as ic
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_train_step
from test_torch_model import jax_variables
from torch_parity import rel_l2, small_configs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, 'tests', 'data', 'gate_int8.msgpack')
GOLDEN = os.path.join(ROOT, 'tests', 'data', 'gate_golden.npz')
BF16 = torch.bfloat16
LOC_REL = 1e-2          # the bf16 final dense, summed in another order
DELTA_REL = 5e-3        # bias_correct's per-channel means, another order
DELTA_ABS = 1e-3        # ... in bias units (these steps are 0.02 and up)
FLOAT_REL = 3e-2        # the bf16 float forward (see the docstring)


def _images(seed, n=2, dim=64):
    return np.random.RandomState(seed).randint(
        0, 256, (n, dim, dim, 3)).astype(np.uint8)


def _s2d_np(x):
    b, h, w, c = x.shape
    return np.ascontiguousarray(
        x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    ).reshape(b, h // 2, w // 2, 4 * c)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(v):
    """A JAX or port output as f32 numpy (bf16 widened exactly)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).numpy() if v.is_floating_point() \
            else v.numpy()
    v = jnp.asarray(v)
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


# --------------------------------------------------------------------------
# the epilogues


def _bf16_ops(q_np, scales):
    """A JAX and a port Int8Ops in the bf16 mode over the sites of `q_np`
    ({site: (w8 HWIO or [K,N], sw, b)})."""
    tq_ = {s: (ic.kernel_layout(w8), _t(sw), _t(b))
           for s, (w8, sw, b) in q_np.items()}
    return (jq.Int8Ops(q_np, {}, scales, acc_dtype=jnp.bfloat16),
            tq.Int8Ops(tq_, {}, scales, acc_dtype=BF16))


def _consume(ops, y, epilogue, xq, sc_site, stride):
    """epilogue's consumer of the pending product `y` through `ops`: the
    requantizing ReLU, the shortcut requantize, the float ReLU, or the
    residual join over a requantized 1x1 shortcut of the same input."""
    if epilogue == 'q8_relu':
        return ops.relu(y, 'out').arr
    if epilogue == 'q8':
        return ops.requant(y, 'out').arr
    if epilogue == 'f32_relu':
        return ops.relu(y)
    if epilogue == 'f32':    # the flatten's requantize after the reshape
        return ops.flatten(y, 'out').arr
    pad = 'VALID' if stride else None
    sc = ops.conv(xq, sc_site, stride, pad) if stride \
        else ops.dense(xq, sc_site)
    return ops.join(y, ops.requant(sc, 'res'), 'out').arr


@pytest.mark.parametrize('epilogue', ['q8_relu', 'q8', 'f32_relu', 'join',
                                      'f32'])
@pytest.mark.parametrize('kh,stride,padding', [(3, 1, 'SAME'),
                                               (1, 2, 'VALID'),
                                               (7, 2, [(3, 3), (3, 3)])])
def test_bf16_conv_epilogues_match_jax_int8ops(epilogue, kh, stride,
                                               padding):
    """A conv site under each consumer, through the JAX package's
    Int8Ops(acc_dtype=bfloat16) under jit and through the port's: 0
    differing elements."""
    rng = np.random.RandomState(11)
    c, n = 16, 24
    q = {}
    for site, k in (('conv', kh), ('sc', 1)):
        w = rng.randn(k, k, c, n).astype(np.float32) * 0.1
        w8, sw = jq.quantize_weight(w)
        q[site] = (w8, sw, rng.randn(n).astype(np.float32) * 0.3)
    jops, tops = _bf16_ops(q, {'out': 3.1, 'res': 1.9})
    x8 = rng.randint(-127, 128, (2, 12, 14, c)).astype(np.int8)
    s_in = 2.7 / 127.0

    def jrun(x):
        xq = jq._QT(x, s_in)
        return _consume(jops, jops.conv(xq, 'conv', stride, padding),
                        epilogue, xq, 'sc', stride)

    want = _np(jax.jit(jrun)(jnp.asarray(x8)))
    xq = tq._QT(_t(x8), s_in)
    got = _np(_consume(tops, tops.conv(xq, 'conv', stride, padding),
                       epilogue, xq, 'sc', stride))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _big_dense(rng, k=4608, n=40, m=64):
    """Dense operands whose accumulators lie above 2^24 (operands near
    127 at the depth of C5's 3x3 convs), with row 0 hitting
    2^24 + 2^16 + 1 in every column: f32 rounds that to 2^24 + 2^16, a
    tie that bf16 rounds to 2^24, where one rounding gives 2^24 + 2^17."""
    x8 = rng.randint(100, 128, (m, k)).astype(np.int8)
    w8 = rng.randint(100, 128, (k, n)).astype(np.int8)
    x8[0] = 0
    x8[0, :1046] = 127
    x8[0, 1045] = 13
    w8[:1046] = 127
    w8[1044], w8[1045] = 32, 1
    sw = rng.uniform(0.9, 1.1, n).astype(np.float32) / 127
    b = rng.randn(n).astype(np.float32)
    return x8, w8, sw, b


def test_big_accumulators_round_twice():
    """The row built to hit 2^24 + 2^16 + 1 does, and the bf16 mode rounds
    it through f32 (to 2^24), as XLA converts s32 to bf16."""
    x8, w8, _, _ = _big_dense(np.random.RandomState(0))
    acc = x8.astype(np.int64) @ w8.astype(np.int64)
    assert (acc[0] == 2 ** 24 + 2 ** 16 + 1).all() and acc.min() > 2 ** 24
    a = ic.bf(torch.from_numpy(acc[:1, :1]).double())
    assert a.item() == 2.0 ** 24
    want = np.asarray(jnp.asarray(acc[:1, :1], jnp.int32).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    assert want.item() == 2.0 ** 24


@pytest.mark.parametrize('epilogue', ['q8_relu', 'q8', 'f32_relu', 'join'])
def test_bf16_dense_epilogues_above_2_24_match_jax_int8ops(epilogue):
    """A dense site at K = 4608 whose accumulators exceed 2^24, under each
    consumer: 0 differing elements."""
    rng = np.random.RandomState(12)
    x8, w8, sw, b = _big_dense(rng)
    q = {'d': (w8, sw, b), 'sc': (w8[:, ::-1].copy(), sw[::-1].copy(), -b)}
    # y ~ acc * alpha of a few units: s_in puts 2^24 at about 3
    s_in = 3.0 / 2 ** 24 * 127
    scales = {'out': 12.0, 'res': 14.0}
    jops, tops = _bf16_ops(q, scales)

    def jrun(x):
        xq = jq._QT(x, s_in)
        return _consume(jops, jops.dense(xq, 'd'), epilogue, xq, 'sc', 0)

    want = _np(jax.jit(jrun)(jnp.asarray(x8)))
    xq = tq._QT(_t(x8), s_in)
    got = _np(_consume(tops, tops.dense(xq, 'd'), epilogue, xq, 'sc', 0))
    np.testing.assert_array_equal(got, want)
    if epilogue != 'f32_relu':
        assert len(np.unique(want)) > 8     # not all clipped


def test_bf16_mode_rounds_where_xla_does():
    """The bf16 epilogue's arithmetic on hand-picked values: the scale
    rounded to bf16, no FMA (the product rounds to bf16 before the add),
    the q8 sum left unrounded, the f32 epilogues writing bf16."""
    acc = torch.tensor([[257, 3, -1000, 1, 1]], dtype=torch.int32)
    alpha = torch.full((5,), 1.0 + 2.0 ** -8 + 2.0 ** -30)  # bf16: 1.0
    beta = torch.tensor([1.0, 0.5, 0.0, 2.0 ** -9, -(0.5 - 2.0 ** -9)])
    kw = dict(alpha=alpha, beta=beta, acc_dtype=BF16)
    y = ic.epilogue_torch(acc, 'f32', **kw)
    assert y.dtype == BF16
    # 257 -> bf16 256, + 1 = 257 -> 256 (an FMA gives 258); 3 + 0.5;
    # -1000 exact; 1 + 2^-9 -> 1; 1 - (0.5 - 2^-9) = 0.5 + 2^-9 -> 0.5
    assert y.float().tolist() == [[256.0, 3.5, -1000.0, 1.0, 0.5]]
    assert ic.epilogue_torch(acc, 'f32_relu', **kw).float().tolist() == \
        [[256.0, 3.5, 0.0, 1.0, 0.5]]
    # q8 rounds the unrounded sum (0.5 + 2^-9 -> 1), q8_relu the bf16 one
    # (0.5 -> 0, half to even)
    assert ic.epilogue_torch(acc, 'q8', inv_s_out=1.0, **kw).tolist() == \
        [[127, 4, -127, 1, 1]]
    assert ic.epilogue_torch(acc, 'q8_relu', inv_s_out=1.0, **kw).tolist() \
        == [[127, 4, 0, 1, 0]]
    # the join: the residual's product and the sum each rounded to bf16
    res = torch.tensor([[1, 3, 0, -1, 1]], dtype=torch.int8)
    q = ic.epilogue_torch(acc, 'join', inv_s_out=1.0, res=res,
                          res_scale=1.0 + 2.0 ** -8, **kw)
    # 256 + 1 = 257 -> 256; 3.5 + 3 = 6.5 -> 6; 1 - 1 = 0; 0.5 + 1 = 1.5 -> 2
    assert q.tolist() == [[127, 6, 0, 0, 2]]
    with pytest.raises(ValueError):
        ic.epilogue_torch(acc, 'f32', alpha=alpha, beta=beta,
                          acc_dtype=torch.float16)


# --------------------------------------------------------------------------
# the int8 model under F16


_VARIANTS = {'base': {}, 's2d': dict(QUANT_STEM_S2D=True),
             'host_s2d': dict(QUANT_STEM_S2D=True, QUANT_HOST_S2D=True)}


@pytest.fixture(scope='module')
def jax_f16():
    """The small configuration under F16 per stem variant, built on first
    use: JAX weights, and the JAX QuantizedModel calibrated on uint8
    images and smoothed. `base` is bias-corrected by JAX (one pass); the
    s2d variants carry its deltas (the same sites and channels), which is
    what their bit-exactness needs, without a JAX sweep each."""
    cache = {}

    def get(variant):
        if variant in cache:
            return cache[variant]
        jcfg, tcfg = small_configs(F16=True, **_VARIANTS[variant])
        if 'tree' not in cache:
            cache['tree'] = jax_variables(jax_build_model(jcfg),
                                          (2, 64, 64, 3), seed=5)
        qm = jq.QuantizedModel.from_variables(
            jcfg, cache['tree']['params'], cache['tree']['batch_stats'])
        x = _images(0)
        if variant == 'host_s2d':
            x = _s2d_np(x)
        qm.calibrate(jnp.asarray(x))
        qm.smooth(0.5)
        smoothed = {k: (np.array(w), np.array(b))
                    for k, (w, b) in qm.flat.items()}
        scales = dict(qm.act_scales)
        if variant == 'base':
            qm.bias_correct(jnp.asarray(x), passes=1)
        else:
            qm.bias_delta = dict(get('base')['qm'].bias_delta)
        cache[variant] = dict(qm=qm, jcfg=jcfg, tcfg=tcfg, x=x,
                              smoothed=smoothed, scales=scales)
        return cache[variant]

    return get


def _carried(pair, deltas=True):
    """The port's model with JAX's smoothed weights and scales (and its
    bias deltas)."""
    want = pair['qm']
    qm = tq.QuantizedModel(pair['tcfg'], pair['smoothed'], device='cpu')
    qm.act_scales = dict(pair['scales'])
    if deltas:
        qm.bias_delta = {k: np.array(v) for k, v in want.bias_delta.items()}
    return qm


def _assert_serves_as_jax(got, want):
    np.testing.assert_array_equal(got['ori'].numpy(), want['ori'])
    assert got['loc'].dtype == torch.float32
    assert rel_l2(got['loc'].numpy(), want['loc']) <= LOC_REL


@pytest.mark.parametrize('variant,u8', [('base', True), ('base', False),
                                        ('s2d', True), ('host_s2d', True),
                                        ('host_s2d', False)])
def test_f16_int8_forward_matches_jax(jax_f16, variant, u8):
    """JAX's calibrated, smoothed and bias-corrected state carried over;
    uint8 pixels (the fused stem under s2d) and molded floats: the int8
    body bit-exact, the plain versions equal to the wrappers."""
    pair = jax_f16(variant)
    x = _images(2)
    if not u8:
        x = x.astype(np.float32) - np.asarray(pair['tcfg'].MEAN_PIXEL,
                                              np.float32)
    if variant == 'host_s2d':
        x = _s2d_np(x)
    want = {k: np.asarray(v) for k, v in pair['qm'](jnp.asarray(x)).items()}
    qm = _carried(pair)
    assert qm.acc_dtype == BF16 and qm._mcfg == pair['qm']._mcfg
    assert qm.bias_delta, 'bias_correct left no deltas to carry'
    got = qm(x)
    _assert_serves_as_jax(got, want)
    plain = qm(x, plain=True)
    for k in got:
        torch.testing.assert_close(plain[k], got[k], rtol=0, atol=0)


def _assert_deltas_match(got, want):
    """The same sites in the same order, each site's delta within
    DELTA_REL of its largest |delta| plus DELTA_ABS."""
    assert list(got) == list(want)
    for site, v in want.items():
        err = float(np.abs(got[site] - v).max())
        assert err <= DELTA_REL * float(np.abs(v).max()) + DELTA_ABS, \
            (site, err)


def test_f16_bias_correct_matches_jax(jax_f16):
    """The port's bias_correct under F16 from JAX's smoothed state, against
    JAX's; the model it corrects serves within the random-init gate of its
    float twin."""
    pair = jax_f16('base')
    qm = _carried(pair, deltas=False)
    report = qm.bias_correct(pair['x'], passes=1)
    _assert_deltas_match(qm.bias_delta, pair['qm'].bias_delta)
    assert report == {k: float(np.abs(v).max())
                      for k, v in qm.bias_delta.items()}
    x = _images(3)
    f, q = qm.float_twin(x), qm(x)
    for k in f:
        assert rel_l2(q[k].numpy(), f[k].numpy()) < tq.RANDOM_INIT_GATE_REL


def test_f16_bias_correct_on_packed_pixels(jax_f16):
    """bias_correct of a host_s2d model, whose calibration batch is packed
    uint8 pixels: the capture pass quantizes them as molded ones (the
    fused stem holds no pre-activation), every quantized site gets a
    delta, and the corrected model passes the random-init gate."""
    pair = jax_f16('host_s2d')
    qm = _carried(pair, deltas=False)
    qm.bias_correct(pair['x'], passes=1)
    fsites = tq.float_sites(qm._mcfg)
    assert set(qm.bias_delta) == set(qm.flat) - fsites
    x = _s2d_np(_images(3))
    f, q = qm.float_twin(x), qm(x)
    for k in f:
        assert rel_l2(q[k].numpy(), f[k].numpy()) < tq.RANDOM_INIT_GATE_REL


def _residuals(qm, x):
    """{site: (max |int8 mean - float mean|, the bound bias_correct leaves
    it within)} of `qm`'s quantized sites on `x`: the per-channel means
    are f32 sums (2e-6 of the largest float mean, plus 1e-5), and under F16
    the bias is rounded to bf16 before and after its correction (an ulp,
    2^-7 of the larger magnitude)."""
    fops = tq.F32Ops(qm._flat_f32(), qm._mcfg['mean_pixel'])
    fops.capture = {}
    ops = qm._int8_ops()
    ops.capture = {}
    xt = torch.from_numpy(x)
    with torch.no_grad():
        tq.twin_forward(fops, xt, qm._mcfg)
        tq.twin_forward(ops, xt, qm._mcfg)
    out = {}
    for site in qm.bias_delta:
        f = fops.capture[site].numpy()
        err = float(np.abs(ops.capture[site].numpy() - f).max())
        bound = 2e-6 * float(np.abs(f).max()) + 1e-5
        if qm.acc_dtype == BF16:
            b0 = np.abs(qm.flat[site][1])
            bound += 2.0 ** -7 * float(np.maximum(
                b0, np.abs(qm.flat[site][1] + qm.bias_delta[site])).max())
        out[site] = (err, bound)
    return out


@pytest.mark.parametrize('f16', [True, False])
def test_bias_correct_zeroes_each_sites_mean_error(f16):
    """The defining property of the sweep, in both modes, from JAX's
    smoothed state: after the port's bias_correct, and with JAX's deltas
    carried instead, the int8 path's per-channel mean equals the float
    twin's at every quantized site (to the f32 sums and, under F16, the
    bf16 bias), and the sites are JAX's, in JAX's order. The deltas
    themselves agree with JAX's only under F16 (the test above): in the
    f32 mode the f32 sums' last bits flip requantized values from the
    third stage on, and the two sweeps settle on other deltas that each
    zero the error."""
    jcfg, tcfg = small_configs(F16=f16)
    tree = jax_variables(jax_build_model(jcfg), (2, 64, 64, 3), seed=5)
    jqm = jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                           tree['batch_stats'])
    x = _images(0)
    jqm.calibrate(jnp.asarray(x))
    jqm.smooth(0.5)
    flat = {k: (np.array(w), np.array(b)) for k, (w, b) in jqm.flat.items()}
    jqm.bias_correct(jnp.asarray(x), passes=1)
    for own in (True, False):
        qm = tq.QuantizedModel(tcfg, flat, device='cpu')
        qm.act_scales = dict(jqm.act_scales)
        if own:
            qm.bias_correct(x, passes=1)
            assert list(qm.bias_delta) == list(jqm.bias_delta)
            first = next(iter(jqm.bias_delta))    # nothing upstream of it
            np.testing.assert_allclose(qm.bias_delta[first],
                                       jqm.bias_delta[first], rtol=0,
                                       atol=DELTA_ABS)
        else:
            qm.bias_delta = {k: np.array(v)
                             for k, v in jqm.bias_delta.items()}
        for site, (err, bound) in _residuals(qm, x).items():
            assert err <= bound, (own, site, err, bound)


def test_bias_correct_leaves_the_float_twin_and_sweeps_again(jax_f16):
    """bias_correct changes only the int8 path (the float twin's outputs
    stay bit for bit), and two passes still zero each site's error."""
    pair = jax_f16('base')
    qm = _carried(pair, deltas=False)
    twin = qm.float_twin(pair['x'])
    qm.bias_correct(pair['x'], passes=2)
    for k, v in qm.float_twin(pair['x']).items():
        torch.testing.assert_close(v, twin[k], rtol=0, atol=0)
    for site, (err, bound) in _residuals(qm, pair['x']).items():
        assert err <= bound, (site, err, bound)


def test_artifact_serves_f16_as_jax_does():
    """The committed flagship artifact at full width (512x640) on one
    golden image under F16 (the mode its golden was exported in), served
    by the JAX package and by the port on the CPU: the orientation logits
    bit-exact, the location within LOC_REL."""
    spec = importlib.util.spec_from_file_location(
        'make_gate_artifact', os.path.join(ROOT, 'tools',
                                           'make_gate_artifact.py'))
    mga = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mga)
    jcfg = mga.config_for_golden(np.load(GOLDEN))
    jcfg.F16 = True
    x = np.load(GOLDEN)['golden_in'][:1]
    want = {k: np.asarray(v) for k, v in
            jqs.load_quantized(ARTIFACT, jcfg)(jnp.asarray(x)).items()}
    qm = tqs.load_quantized(ARTIFACT, presets.serving_config(batch=1),
                            device='cpu')
    assert qm.acc_dtype == BF16
    _assert_serves_as_jax(qm(x), want)


# --------------------------------------------------------------------------
# the bf16 float forward


def test_bf16_float_forward_matches_jax_apply():
    """The float model under F16 (f32 parameters, bf16 compute, batch
    norm in f32 on its statistics) against the JAX model's F16 `apply` in
    eval, op by op, on molded inputs: the heads within FLOAT_REL, f32
    outputs, and bf16 was computed (the f32 model is further away than
    their f32 comparison's tolerance)."""
    jcfg, tcfg = small_configs(F16=True)
    jmodel = jax_build_model(jcfg)
    tree = jax_variables(jmodel, (2, 64, 64, 3), seed=7)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32) * 50
    want = jmodel.apply(tree, jnp.asarray(x), training=False)
    model = build_model(tcfg, device='cpu').eval()
    model.load_state_dict(params_from_jax(tree))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = model(xt)
    for k in ('loc', 'ori'):
        assert got[k].dtype == torch.float32
        assert got[k].shape == want[k].shape
        assert rel_l2(got[k].numpy(), np.asarray(want[k])) <= FLOAT_REL, k
    model32 = build_model(small_configs()[1], device='cpu').eval()
    model32.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        got32 = model32(xt)
    assert rel_l2(got['ori'].numpy(), got32['ori'].numpy()) > 1e-4


def test_bf16_float_block_rounds_where_jax_does():
    """The first residual block's bf16 output, with random conv biases,
    against the JAX model's (op-by-op apply): the same values but for the
    rare bf16 roundings that f32 sums in another order flip (measured
    0.17% of the elements): every conv, bias add and batch norm rounds
    where flax's does. The heads' FLOAT_REL is those flips grown through
    sixteen blocks."""
    jcfg, tcfg = small_configs(F16=True)
    jmodel = jax_build_model(jcfg)
    tree = jax_variables(jmodel, (2, 64, 64, 3), seed=7)
    rng = np.random.RandomState(3)

    def biases(d):
        return {k: biases(v) if isinstance(v, dict) else
                (rng.randn(*v.shape).astype(np.float32) * 0.5
                 if k == 'bias' and 'kernel' in d else v)
                for k, v in d.items()}
    tree = dict(tree, params=biases(tree['params']))
    x = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32) * 50
    _, state = jmodel.apply(tree, jnp.asarray(x), training=False,
                            capture_intermediates=True,
                            mutable=['intermediates'])
    want = _np(state['intermediates']['backbone']['res2a']['__call__'][0])
    model = build_model(tcfg, device='cpu').eval()
    model.load_state_dict(params_from_jax(tree))
    seen = {}
    model.backbone.res2a.register_forward_hook(
        lambda mod, inp, out: seen.setdefault('res2a', out))
    with torch.no_grad():
        model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = seen['res2a']
    assert got.dtype == BF16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    assert (got != want).mean() <= 0.01
    assert rel_l2(got, want) <= 1e-3


def test_engine_serves_the_bf16_float_forward_and_train_refuses_f16():
    """ServingEngine.predict_molded under F16 (no int8 model) runs the
    bf16 forward and returns f32; mold_image casts to float16 as the JAX
    package's. The F16 train step, which refused F16 until the bf16 step
    was ported, now takes it (held against JAX in
    tests/test_torch_bf16_train.py): one step keeps the parameters f32."""
    _, tcfg = small_configs(F16=True)
    eng = ServingEngine(tcfg, 'cpu', generator=torch.Generator().manual_seed(0))
    molded, _, _ = eng.mold_inputs(list(_images(4)))
    assert molded.dtype == np.float16
    out = eng.predict_molded(molded)
    with torch.no_grad():
        ref = eng.model(torch.from_numpy(molded.astype(np.float32))
                        .permute(0, 3, 1, 2))
    for k in ('loc', 'ori'):
        assert out[k].dtype == torch.float32 and torch.isfinite(out[k]).all()
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
    step = make_train_step(eng.model, tcfg, make_optimizer(tcfg),
                           device='cpu')
    grid = torch.full((2, tcfg.ORI_BINS_PER_DIM ** 3),
                      1.0 / tcfg.ORI_BINS_PER_DIM ** 3)
    metrics = step({'images': torch.from_numpy(
                        molded.astype(np.float32)).permute(0, 3, 1, 2),
                    'gt_loc': torch.ones(2, 3), 'gt_ori': grid})
    assert np.isfinite(float(metrics['loss']))
    assert all(p.dtype == torch.float32 for p in eng.model.parameters())
