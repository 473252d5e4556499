"""The int8 serving knobs `bench.py` reads, in the port
(`ursonet_torch/models/quant.py`, `ops/int8_cuda.py`) against the JAX
package's `QuantizedModel` on the same weights and inputs (numpy seeds),
on the CPU, where the kernels run their plain versions: integer residual
joins (QUANT_S8_JOIN, the `join_s8` epilogue), the float residual join
of an artifact calibrated before the shortcut requant sites existed, and
the bf16 stem (QUANT_BF16_STEM).

Tolerances:
  * QUANT_S8_JOIN and the float residual join, ResNet-18 and ResNet-50,
    f32 and F16, with JAX's calibrated scales carried over: the
    orientation logits (the int8 body end to end) bit-exact, `loc`
    within the final dense's reordering (relative L2 1e-3 with f32
    epilogues, 1e-2 under F16; measured 0);
  * QUANT_BF16_STEM: the stem conv is summed in another order than
    XLA's (and its product and bias added without XLA's FMA), so the
    requantized stem may differ by 1 in a few elements (at most 1e-3 of
    them; measured 1 of 131072 under F16 in the s2d forms, 0 elsewhere)
    and the heads within relative L2 2e-2 (measured 0);
  * bias_correct under QUANT_S8_JOIN (whose capture pass keeps the
    default joins, as the JAX package's): under F16 every site's delta
    within 5e-3 of that site's largest |delta| plus 1e-3, as in
    tests/test_torch_f16.py (per-channel means summed in another order);
    in both modes each package's deltas leave every site's mean error
    within that file's bounds;
  * the artifact under each knob: the same bits after a round trip.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu.models import quant as jq
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_torch import presets
from ursonet_torch.checkpoint import quant_store as tqs
from ursonet_torch.models import quant as tq
from ursonet_torch.ops import int8_cuda as ic
from test_torch_model import jax_variables
from torch_parity import rel_l2, small_configs

torch.set_num_threads(2)

LOC_REL = {False: 1e-3, True: 1e-2}     # by F16
STEM_FLIPS = 1e-3       # share of the bf16 stem's outputs that may differ
STEM_REL = 2e-2         # the heads behind the bf16 stem
DELTA_REL = 5e-3
DELTA_ABS = 1e-3


def _images(seed, n=2, dim=64):
    return np.random.RandomState(seed).randint(
        0, 256, (n, dim, dim, 3)).astype(np.uint8)


def _s2d_np(x):
    b, h, w, c = x.shape
    return np.ascontiguousarray(
        x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    ).reshape(b, h // 2, w // 2, 4 * c)


@pytest.fixture(scope='module')
def jax_trees():
    """JAX weights (random, random BN) per backbone, built on first use."""
    cache = {}

    def get(backbone):
        if backbone not in cache:
            jcfg, _ = small_configs(BACKBONE=backbone)
            cache[backbone] = jax_variables(jax_build_model(jcfg),
                                            (2, 64, 64, 3), seed=5)
        return cache[backbone]
    return get


def _pair(tree, drop_sc=False, calib=None, **knobs):
    """The JAX QuantizedModel under `knobs` calibrated on uint8 images
    (`calib`, packed under host_s2d), and the port's model carrying its
    folded weights and scales; `drop_sc` removes the shortcut requant
    sites from both, as an artifact calibrated before they existed."""
    jcfg, tcfg = small_configs(**knobs)
    jqm = jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                           tree['batch_stats'])
    x = _images(0) if calib is None else calib
    jqm.calibrate(jnp.asarray(x))
    if drop_sc:
        jqm.act_scales = {k: v for k, v in jqm.act_scales.items()
                          if not k.endswith(('branch1/out', 'sc/out'))}
    qm = tq.QuantizedModel(tcfg, jqm.flat, device='cpu')
    qm.act_scales = dict(jqm.act_scales)
    assert qm._mcfg == jqm._mcfg
    return jqm, qm


def _assert_body_exact(jqm, qm, x, f16):
    want = {k: np.asarray(v) for k, v in jqm(jnp.asarray(x)).items()}
    got = qm(x)
    np.testing.assert_array_equal(got['ori'].numpy(), want['ori'])
    assert rel_l2(got['loc'].numpy(), want['loc']) <= LOC_REL[f16]
    plain = qm(x, plain=True)
    for k in got:
        torch.testing.assert_close(plain[k], got[k], rtol=0, atol=0)
    return got


@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'F16'])
@pytest.mark.parametrize('backbone', ['resnet18', 'resnet50'])
def test_s8_join_forward_matches_jax(jax_trees, backbone, f16):
    """QUANT_S8_JOIN: every residual join (the bottleneck 2c GEMMs, the
    basic blocks' conv2) in join_s8; the int8 body bit-exact."""
    jqm, qm = _pair(jax_trees(backbone), BACKBONE=backbone, F16=f16,
                    QUANT_S8_JOIN=True)
    assert qm._mcfg['s8_join'] and qm._int8_ops().s8_join
    x = _images(2)
    got = _assert_body_exact(jqm, qm, x, f16)
    # the integer join is another formula than the default one
    qm._mcfg = dict(qm._mcfg, s8_join=False)
    assert not torch.equal(qm(x)['ori'], got['ori'])


@pytest.mark.parametrize('s8_join', [False, True], ids=['join', 's8_join'])
@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'F16'])
@pytest.mark.parametrize('backbone', ['resnet18', 'resnet50'])
def test_float_residual_join_matches_jax(jax_trees, backbone, f16, s8_join):
    """Without the shortcut requant sites (`branch1/out`, `sc/out`) the
    shortcut conv serves in float and the join adds it as it is: `join`
    over the 'f32' epilogue's output (bf16 under F16), or join_s8 over
    'f32_sum' (f32: XLA drops that bf16 rounding); the int8 body
    bit-exact."""
    jqm, qm = _pair(jax_trees(backbone), drop_sc=True, BACKBONE=backbone,
                    F16=f16, QUANT_S8_JOIN=s8_join)
    assert not any(k.endswith(('branch1/out', 'sc/out'))
                   for k in qm.act_scales)
    _assert_body_exact(jqm, qm, _images(2), f16)


def test_requant_without_its_site_serves_the_float_shortcut():
    """Int8Ops.requant on a site the scales lack: the shortcut conv's
    float output, f32 or bf16 by mode ('f32'), f32 in both under
    s8_join ('f32_sum', the bf16 mode's unrounded sum)."""
    rng = np.random.RandomState(0)
    w8 = rng.randint(-127, 128, (1, 1, 16, 8)).astype(np.int8)
    q = {'sc': (ic.kernel_layout(w8), torch.from_numpy(
        rng.uniform(0.01, 0.02, 8).astype(np.float32)),
        torch.from_numpy(rng.uniform(-1, 1, 8).astype(np.float32)))}
    x = tq._QT(torch.from_numpy(rng.randint(-127, 128, (2, 4, 4, 16))
                                .astype(np.int8)), 0.05)
    for acc, s8_join, want in ((torch.float32, False, torch.float32),
                               (torch.bfloat16, False, torch.bfloat16),
                               (torch.bfloat16, True, torch.float32)):
        ops = tq.Int8Ops(q, {}, {}, acc_dtype=acc, s8_join=s8_join)
        y = ops.requant(ops.conv(x, 'sc', 1, 'VALID'), 'sc/out')
        assert isinstance(y, torch.Tensor) and y.dtype == want
        if s8_join:   # the unrounded sum, which rounds to the 'f32' bits
            z = tq.Int8Ops(q, {}, {}, acc_dtype=acc).requant(
                ops.conv(x, 'sc', 1, 'VALID'), 'sc/out')
            assert torch.equal(y.to(torch.bfloat16), z)
            assert not torch.equal(y, z.to(torch.float32))


def test_join_epilogues_plain_formulas():
    """join_s8 rounds both operands onto the output grid and clips their
    integer sum; a float residual enters `join` as it is (res_scale 1:
    relu(y + res) requantized); f32_sum is the unrounded sum."""
    rng = np.random.RandomState(1)
    acc = torch.from_numpy(rng.randint(-5000, 5000, (64, 32))
                           .astype(np.float64))
    alpha = torch.from_numpy(rng.uniform(1e-4, 1e-3, 32).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(-1, 1, 32).astype(np.float32))
    res = torch.from_numpy(rng.randint(-127, 128, (64, 32)).astype(np.int8))
    inv = float(np.float32(1) / np.float32(3.0 / 127))
    for dt in ic.ACC_DTYPES:
        s = ic.epilogue_sum(acc, alpha, beta, dt)
        got = ic.epilogue_torch(acc, 'join_s8', alpha, beta, inv, res, 0.61,
                                dt)
        want = np.clip(np.round(s.numpy() * np.float32(inv))
                       + np.round(res.numpy().astype(np.float32)
                                  * np.float32(0.61)), 0, 127)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int8))
        torch.testing.assert_close(
            ic.epilogue_torch(acc, 'f32_sum', alpha, beta, acc_dtype=dt), s,
            rtol=0, atol=0)
        flt = ic.epilogue_torch(acc, 'f32', alpha, beta, acc_dtype=dt)
        y = ic.epilogue_torch(acc, 'f32', alpha, beta, acc_dtype=dt) \
            .to(torch.float32)
        got = ic.epilogue_torch(acc, 'join', alpha, beta, inv, flt, 1.0, dt)
        z = y + flt.to(torch.float32)
        if dt == torch.bfloat16:
            z = ic.bf(z)
        want = torch.clamp(torch.round(torch.relu(z) * np.float32(inv)),
                           0, 127)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize('variant,f16', [('base', False), ('base', True),
                                         ('s2d', True), ('host_s2d', True)])
def test_bf16_stem_matches_jax(jax_trees, variant, f16):
    """QUANT_BF16_STEM: the molded pixels in bf16 and the stem conv in
    float (f32 accumulation) over them and the stored int8 kernel, from
    uint8 and from molded input, in the `base`, `s2d` and `host_s2d`
    forms: the requantized stem and the heads at the stated tolerances
    (the conv's summation order)."""
    knobs = {'base': {}, 's2d': dict(QUANT_STEM_S2D=True),
             'host_s2d': dict(QUANT_STEM_S2D=True, QUANT_HOST_S2D=True)}
    pack = _s2d_np if variant == 'host_s2d' else (lambda a: a)
    jqm, qm = _pair(jax_trees('resnet18'), calib=pack(_images(0)),
                    BACKBONE='resnet18', F16=f16, QUANT_BF16_STEM=True,
                    **knobs[variant])
    assert qm._mcfg['bf16_stem']
    raw = _images(2)
    molded = raw.astype(np.float32) - np.asarray(qm._mcfg['mean_pixel'],
                                                 np.float32)
    for x in (pack(raw), pack(molded)):
        # the stem's requantized output, op by op in both packages
        jops = jq.Int8Ops(jq.Int8Ops.prepare(jqm.flat), {}, jqm.act_scales,
                          jqm.acc_dtype, mean_pixel=jqm._mcfg['mean_pixel'],
                          bf16_stem=True)
        want = np.asarray(jops.relu(jq._stem(jops, jops.input(
            jnp.asarray(x)), jqm._mcfg, 'conv0'), 'conv0/out').arr)
        tops = qm._int8_ops()
        got = tops.relu(tq._stem(tops, tops.input(torch.from_numpy(x)),
                                 qm._mcfg, 'conv0'), 'conv0/out').arr.numpy()
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= STEM_FLIPS
        # the model end to end, and the plain path equal to the kernels'
        ref = {k: np.asarray(v) for k, v in jqm(jnp.asarray(x)).items()}
        out = qm(x)
        for k in ref:
            assert rel_l2(out[k].numpy(), ref[k]) <= STEM_REL, k
        plain = qm(x, plain=True)
        for k in out:
            torch.testing.assert_close(plain[k], out[k], rtol=0, atol=0)


def test_bf16_stem_takes_no_stem_kernel():
    """Under QUANT_BF16_STEM a uint8 batch of an s2d model takes neither
    the fused stem nor the input quantize: its molded pixels go on in
    bf16, and the stem conv's ReLU requantizes the float conv."""
    _, tcfg = small_configs(BACKBONE='resnet18', QUANT_STEM_S2D=True,
                            QUANT_HOST_S2D=True)
    mean = tcfg.MEAN_PIXEL
    rng = np.random.RandomState(0)
    w8 = rng.randint(-127, 128, (4, 4, 12, 8)).astype(np.int8)
    q = {'conv0': (ic.kernel_layout(w8), torch.full((8,), 1e-3),
                   torch.zeros(8))}
    x8 = torch.from_numpy(_s2d_np(_images(0)))
    for bf16_stem in (False, True):
        ops = tq.Int8Ops(q, {}, {'input': 300.0, 'conv0/out': 30.0},
                         mean_pixel=mean, fused_stem=True,
                         bf16_stem=bf16_stem)
        x = ops.input(x8)
        assert isinstance(x, tq._U8) != bf16_stem
        y = ops.relu(ops.conv(x, 'conv0', 1, [(2, 1), (2, 1)]), 'conv0/out')
        assert isinstance(y, tq._PendingStem) != bf16_stem
    assert x.dtype == torch.bfloat16
    assert isinstance(y, tq._QT) and y.arr.dtype == torch.int8


def _mean_errors(qm, x):
    """{site: (max |int8 mean - float mean|, its bound)} on `x`, measured
    as bias_correct measures them (the default joins), with the bounds of
    tests/test_torch_f16.py::_residuals: the f32 sums, and under F16 a
    bf16 ulp of the bias."""
    fops = tq.F32Ops(qm._flat_f32(), qm._mcfg['mean_pixel'])
    fops.capture = {}
    ops = qm._int8_ops(s8_join=False)
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
        if qm.acc_dtype == torch.bfloat16:
            b0 = np.abs(qm.flat[site][1])
            bound += 2.0 ** -7 * float(np.maximum(
                b0, np.abs(qm.flat[site][1] + qm.bias_delta[site])).max())
        out[site] = (err, bound)
    return out


@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'F16'])
def test_bias_correct_under_s8_join_matches_jax(jax_trees, f16):
    """bias_correct of a QUANT_S8_JOIN model: the capture pass keeps the
    default joins in both packages (a quirk of the JAX package's, kept
    for parity). The same sites in JAX's order; under F16 the port's
    deltas equal JAX's within DELTA_REL (in the f32 mode the two sweeps
    settle on other deltas from the second stage on, as without the knob:
    tests/test_torch_f16.py); in both modes each package's deltas zero
    every site's mean error as the capture pass measures it, and the
    corrected model serves within the random-init gate."""
    jqm, qm = _pair(jax_trees('resnet18'), BACKBONE='resnet18', F16=f16,
                    QUANT_S8_JOIN=True)
    x = _images(0)
    jqm.bias_correct(jnp.asarray(x), passes=1)
    qm.bias_correct(x, passes=1)
    assert list(qm.bias_delta) == list(jqm.bias_delta)
    if f16:
        for site, v in jqm.bias_delta.items():
            err = float(np.abs(qm.bias_delta[site] - v).max())
            assert err <= DELTA_REL * float(np.abs(v).max()) + DELTA_ABS, \
                (site, err)
    for site, (err, bound) in _mean_errors(qm, x).items():
        assert err <= bound, (site, err, bound)
    f, q = qm.float_twin(_images(3)), qm(_images(3))
    for k in f:
        assert rel_l2(q[k].numpy(), f[k].numpy()) < tq.RANDOM_INIT_GATE_REL
    qm.bias_delta = {k: np.array(v) for k, v in jqm.bias_delta.items()}
    qm._q_dev = None
    for site, (err, bound) in _mean_errors(qm, x).items():
        assert err <= bound, ('jax', site, err, bound)


@pytest.mark.parametrize('knobs', [dict(QUANT_S8_JOIN=True),
                                   dict(QUANT_BF16_STEM=True),
                                   dict(QUANT_S8_JOIN=True,
                                        QUANT_BF16_STEM=True, F16=True)])
def test_artifact_round_trip_under_each_knob(jax_trees, tmp_path, knobs):
    """save_quantized -> load_quantized under the knob serves the same
    bits; bf16_stem is checked against the config, s8_join recorded but
    not checked (as the JAX package's artifact)."""
    _, qm = _pair(jax_trees('resnet18'), BACKBONE='resnet18', **knobs)
    x = _images(4)
    want = qm(x)
    path = str(tmp_path / 'q.msgpack')
    tqs.save_quantized(path, qm)
    _, cfg = small_configs(BACKBONE='resnet18', **knobs)
    got = tqs.load_quantized(path, cfg, device='cpu')
    assert got._mcfg == qm._mcfg
    for k, v in got(x).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    bad = dict(knobs, QUANT_BF16_STEM=not knobs.get('QUANT_BF16_STEM'))
    with pytest.raises(ValueError, match='bf16_stem'):
        tqs.load_quantized(path, small_configs(BACKBONE='resnet18',
                                               **bad)[1], device='cpu')
    _, cfg = small_configs(BACKBONE='resnet18', **dict(
        knobs, QUANT_S8_JOIN=not knobs.get('QUANT_S8_JOIN')))
    assert tqs.load_quantized(path, cfg, device='cpu')._mcfg['s8_join'] \
        != qm._mcfg['s8_join']


def test_serving_config_takes_the_bench_knobs():
    """serving_config's inner_mult / s8_join / bf16_stem are the fields
    bench.py sets from BENCH_INNER_MULT / BENCH_S8_JOIN /
    BENCH_BF16_STEM, at the JAX Config's defaults when off."""
    from ursonet_tpu.config import Config as JaxConfig
    cfg = presets.serving_config(inner_mult=0.6, s8_join=True,
                                 bf16_stem=True)
    assert (cfg.INNER_WIDTH_MULT, cfg.QUANT_S8_JOIN, cfg.QUANT_BF16_STEM) \
        == (0.6, True, True)
    base = presets.serving_config()
    assert (base.INNER_WIDTH_MULT, base.QUANT_S8_JOIN,
            base.QUANT_BF16_STEM) == (1.0, False, False)
    for k in ('INNER_WIDTH_MULT', 'QUANT_S8_JOIN', 'QUANT_BF16_STEM'):
        assert getattr(JaxConfig(), k, False) == getattr(base, k)
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'bench.py')) as f:
        bench = f.read()
    for env, key in (('BENCH_INNER_MULT', 'INNER_WIDTH_MULT'),
                     ('BENCH_S8_JOIN', 'QUANT_S8_JOIN'),
                     ('BENCH_BF16_STEM', 'QUANT_BF16_STEM')):
        assert f'config.{key} =' in bench and env in bench


# --------------------------------------------------------------------------
# what the host decides for the new epilogues


# the flagship's 2c joins at batch 128, 512x640: (rows, K, N) per stage
JOIN_GEMMS = [(128 * 128 * 160, 64, 256), (128 * 64 * 80, 128, 512),
              (128 * 32 * 40, 256, 1024), (128 * 16 * 20, 512, 2048)]


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('epilogue', ic.JOINS)
@pytest.mark.parametrize('res_bytes', [0, 2, 4])
def test_join_plans_fit_beside_their_residual(epilogue, res_bytes, acc):
    """The TMA route's plan for the joins: no split over K; tiles at most
    128 wide beside a bf16 residual and 64 beside an f32 one, whose
    slots give up stages or buffers; the shared memory within the limit,
    the sum of its parts."""
    for m, k, n in JOIN_GEMMS + [(5000, 128, 512), (700, 304, 2048)]:
        plan = ic.hopper_plan(m, k, n, epilogue, acc_dtype=acc,
                              res_bytes=res_bytes)
        s8 = ic.hopper_plan(m, k, n, epilogue, acc_dtype=acc)
        assert plan['splits'] == 1 and plan['smem'] <= ic.SMEM_LIMIT
        assert plan['bn'] <= {0: 256, 2: 128, 4: 64}[res_bytes]
        depths = ic._DEPTHS_JOIN_FLOAT if res_bytes else ic._DEPTHS_JOIN
        assert (plan['stages'], plan['bufs']) in depths
        assert plan['smem'] == ic.tma_smem_bytes(
            plan['bn'], 1, plan['stages'], plan['bufs'], plan['resident'],
            plan['ksteps'], plan['n_tiles'], res_bytes)
        if res_bytes and plan['bn'] == s8['bn'] \
                and plan['resident'] == s8['resident']:
            assert (plan['stages'], plan['bufs']) <= (s8['stages'],
                                                      s8['bufs'])
    assert ic.hopper_plan(5000, 128, 512, epilogue, acc_dtype=acc,
                          res_bytes=4)['stages'] < 4
    assert ic.res_bytes(epilogue, torch.float32) == 4
    assert ic.res_bytes(epilogue, torch.int8) == 0
    assert ic.res_bytes('q8', torch.float32) == 0
    assert ic.OUT_BYTES[acc][epilogue] == 1
    assert ic.OUT_BYTES[acc]['f32_sum'] == 4


@pytest.mark.parametrize('mult', [0.5, 0.6, 1.0])
def test_pruned_flagship_routes(mult):
    """The pruned flagship's products on the route their shapes give
    them: at 0.5 (inner widths 32/64/128/256) and 1.0 every GEMM and
    3x3 conv on the TMA route; at 0.6 (40/80/152/304) the 2a outputs
    (N = 40, 152), the 2b convs (C = 40, 152) and the 2c joins
    (K = 40, 152) of C2 and C4 on the mma.sync one, those of C3 and C5
    on the TMA route."""
    from ursonet_torch.models.resnet import scale_inner
    for rows, f, out, cin in ((128 * 128 * 160, 64, 256, 64),
                              (128 * 64 * 80, 128, 512, 256),
                              (128 * 32 * 40, 256, 1024, 512),
                              (128 * 16 * 20, 512, 2048, 1024)):
        g = scale_inner(f, mult)
        want = 'tma' if g % 16 == 0 else 'ragged'
        assert want == ('ragged' if mult == 0.6 and f in (64, 256)
                        else 'tma')
        for ep, acc in (('q8_relu', torch.bfloat16),
                        ('q8_relu', torch.float32),
                        ('join', torch.bfloat16), ('join_s8', torch.float32)):
            k, n = (cin, g) if ep == 'q8_relu' else (g, out)
            assert ic.gemm_route(rows, k, n, ep, acc_dtype=acc) == want
        assert ic.conv_route(g, g) == want
        assert ic.gemm_route(rows, cin, out, 'q8', acc_dtype=torch.bfloat16) \
            == 'tma'
