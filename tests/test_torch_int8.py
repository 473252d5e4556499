"""The int8 kernels' plain versions (`ursonet_torch/ops/int8_cuda.py`:
`gemm_s8_torch`, `conv_s8_torch`, which the CPU runs and the card holds
the CUDA kernels against) against the TPU kernels they port, run as the
JAX package's probes run them on the CPU (Pallas interpret mode), and
against XLA's int8 convolution and the JAX package's Int8Ops epilogues.
All bit-exact: the port's epilogue rounds as XLA's compiled one does
(the FMA XLA contracts, the multiply by the reciprocal step).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ursonet_tpu.models import quant as jq
from ursonet_torch.models import quant as tq
from ursonet_torch.ops import int8_cuda as ic

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _s8(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# kernel 5: tools/probe_pallas_conv3.py::_conv_kernel


@pytest.mark.parametrize('h,w,c,n,rpt', [(8, 16, 128, 128, 4),
                                         (6, 10, 256, 256, 2)])
@pytest.mark.parametrize('out', ['q8_relu', 'f32'])
def test_conv_matches_pallas_conv3(h, w, c, n, rpt, out):
    """The probe's check() shapes: a pre-padded input, VALID 3x3/1 conv,
    pre-scaled ReLU + requant (s_out = 1) or the f32 epilogue."""
    probe = _probe('probe_pallas_conv3')
    rng = np.random.RandomState(0)
    x = _s8(rng, (2, h + 2, w + 2, c))
    w8 = _s8(rng, (3, 3, c, n))
    alpha = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    beta = rng.uniform(-1, 1, n).astype(np.float32)
    wp = w + 2 + (-(w + 2)) % 8
    xp = np.zeros((2, h + 2, wp, c), np.int8)
    xp[:, :, :w + 2] = x
    want = np.asarray(probe.conv3x3_int8(
        jnp.asarray(xp), w8, alpha, beta, w=w, rows_per_tile=rpt,
        out_dtype=jnp.int8 if out == 'q8_relu' else jnp.float32,
        interpret=True))
    got = ic.conv_s8(_t(x), ic.kernel_layout(w8), 1, ((0, 0), (0, 0)), out,
                     alpha=_t(alpha), beta=_t(beta), inv_s_out=1.0)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# kernel 2: tools/probe_pallas_int8_matmul.py::_matmul_kernel


@pytest.mark.parametrize('tm,tn,tk', [(128, 128, 128), (64, 128, 256)])
def test_gemm_matches_pallas_int8_matmul(tm, tn, tk):
    probe = _probe('probe_pallas_int8_matmul')
    rng = np.random.RandomState(0)
    a = rng.randint(-128, 128, (128, 256)).astype(np.int8)
    b = rng.randint(-128, 128, (256, 128)).astype(np.int8)
    want = np.asarray(probe.pallas_int8_matmul(
        jnp.asarray(a), jnp.asarray(b), tm, tn, tk, interpret=True))
    got = ic.gemm_s8(_t(a), ic.kernel_layout(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# kernel 6: tools/probe_pallas_c2.py::matmul_requant_kernel


def _pallas_c2(x, w, alpha, beta, tile_m):
    probe = _probe('probe_pallas_c2')
    m, k = x.shape
    n = w.shape[1]
    return pl.pallas_call(
        probe.matmul_requant_kernel,
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.int8),
        grid=(m // tile_m,),
        in_specs=[pl.BlockSpec((tile_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0)),
                  pl.BlockSpec((1, n), lambda i: (0, 0)),
                  pl.BlockSpec((1, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((tile_m, n), lambda i: (i, 0)),
        interpret=True)(x, w, alpha, beta)


@pytest.mark.parametrize('cin,cout', [(64, 256), (256, 64)])
def test_gemm_matches_pallas_c2(cin, cout):
    """The C2 1x1 conv kinds of the probe, at a small M: the Pallas
    kernel in interpret mode and the probe's XLA conv agree with the
    plain version's q8_relu at s_out = 1."""
    probe = _probe('probe_pallas_c2')
    rng = np.random.RandomState(1)
    b, h, w = 2, 8, 16
    m = b * h * w
    x = _s8(rng, (m, cin))
    wk = _s8(rng, (cin, cout))
    alpha = np.full((1, cout), 0.00123, np.float32)
    beta = np.linspace(-3, 3, cout, dtype=np.float32).reshape(1, -1)
    want = np.asarray(_pallas_c2(jnp.asarray(x), jnp.asarray(wk),
                                 jnp.asarray(alpha), jnp.asarray(beta), 64))
    want_xla = np.asarray(probe.xla_conv_s8(
        jnp.asarray(x.reshape(b, h, w, cin)),
        jnp.asarray(wk.reshape(1, 1, cin, cout)), alpha, beta))
    np.testing.assert_array_equal(want_xla.reshape(m, cout), want)
    got = ic.gemm_s8(_t(x), ic.kernel_layout(wk), 'q8_relu',
                     alpha=_t(alpha[0]), beta=_t(beta[0]), inv_s_out=1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    got4 = ic.conv_s8(_t(x.reshape(b, h, w, cin)),
                      ic.kernel_layout(wk.reshape(1, 1, cin, cout)), 1,
                      ((0, 0), (0, 0)), 'q8_relu', alpha=_t(alpha[0]),
                      beta=_t(beta[0]), inv_s_out=1.0)
    np.testing.assert_array_equal(got4.numpy().reshape(m, cout), want)


# --------------------------------------------------------------------------
# XLA's int8 convolution: the stem and the stride-2 convs


def _xla_conv_s32(x, w8, stride, padding):
    dn = jax.lax.conv_dimension_numbers(x.shape, w8.shape,
                                        ('NHWC', 'HWIO', 'NHWC'))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w8), (stride, stride), padding,
        dimension_numbers=dn, preferred_element_type=jnp.int32))


@pytest.mark.parametrize('name,h,w,c,kh,n,stride,padding', [
    ('stem 7x7/2', 32, 40, 3, 7, 64, 2, ((3, 3), (3, 3))),
    ('bottleneck 3x3/2 SAME', 16, 20, 64, 3, 24, 2, ((0, 1), (0, 1))),
    ('2b 3x3/1 SAME', 9, 7, 32, 3, 40, 1, ((1, 1), (1, 1))),
    ('2a/branch1 1x1/2', 16, 20, 48, 1, 32, 2, ((0, 0), (0, 0))),
    ('odd 3x3/2 SAME', 9, 11, 16, 3, 8, 2, ((1, 1), (1, 1)))])
def test_conv_matches_xla_int8_conv(name, h, w, c, kh, n, stride, padding):
    rng = np.random.RandomState(2)
    x = rng.randint(-128, 128, (2, h, w, c)).astype(np.int8)
    w8 = rng.randint(-128, 128, (kh, kh, c, n)).astype(np.int8)
    want = _xla_conv_s32(x, w8, stride, list(padding))
    got = ic.conv_s8(_t(x), ic.kernel_layout(w8), stride, padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the pads the port derives from 'SAME' are XLA's
    if name.endswith('SAME'):
        assert tq._pads('SAME', h, w, kh, kh, stride) == padding
        np.testing.assert_array_equal(
            _xla_conv_s32(x, w8, stride, 'SAME'), want)


# --------------------------------------------------------------------------
# the JAX package's Int8Ops epilogues (the requantizing serving form)


def _int8ops_pair(rng, c, n, kh):
    """A JAX and a port Int8Ops over two conv sites with calibrated-like
    scales: 'in' -> 'conv' -> 'conv/out', and a shortcut 'sc' -> 'res'
    of the same output shape (a 1x1 conv with the same stride)."""
    scales = {'in': 2.7, 'conv/out': 3.1, 'res': 1.9}
    jq_, tq_ = {}, {}
    for site, k in (('conv', kh), ('sc', 1)):
        w = rng.randn(k, k, c, n).astype(np.float32) * 0.1
        b = rng.randn(n).astype(np.float32) * 0.3
        w8, sw = jq.quantize_weight(w)
        jq_[site] = (w8, sw, b)
        tq_[site] = (ic.kernel_layout(w8), _t(sw), _t(b))
    return jq.Int8Ops(jq_, {}, scales), tq.Int8Ops(tq_, {}, scales)


@pytest.mark.parametrize('epilogue', ['q8_relu', 'q8', 'f32_relu', 'join'])
@pytest.mark.parametrize('kh,stride,padding', [(3, 1, 'SAME'),
                                               (1, 2, 'VALID'),
                                               (7, 2, [(3, 3), (3, 3)])])
def test_epilogues_match_jax_int8ops(epilogue, kh, stride, padding):
    """conv -> relu(site) / requant(site) / relu() / join(site) through
    the JAX package's Int8Ops under jit (its serving form: XLA contracts
    acc * alpha + beta into an FMA and multiplies by the reciprocal of
    the constant step) and through the port's fused epilogues:
    bit-exact. The join's shortcut comes from a requantized 1x1 conv in
    the same graph, as in the model: XLA then adds the dequantized
    residual without contracting it (given the residual as an input
    instead, it contracts it into an FMA)."""
    rng = np.random.RandomState(3)
    c, n = 16, 24
    jops, tops = _int8ops_pair(rng, c, n, kh)
    x8 = rng.randint(-127, 128, (2, 12, 14, c)).astype(np.int8)
    s_in = 2.7 / 127.0

    def jrun(x):
        xq = jq._QT(x, s_in)
        y = jops.conv(xq, 'conv', stride, padding)
        if epilogue == 'q8_relu':
            return jops.relu(y, 'conv/out').arr
        if epilogue == 'q8':
            return jops.requant(y, 'conv/out').arr
        if epilogue == 'f32_relu':
            return jops.relu(y)
        sc = jops.requant(jops.conv(xq, 'sc', stride, 'VALID'), 'res')
        return jops.join(y, sc, 'conv/out').arr

    want = np.asarray(jax.jit(jrun)(jnp.asarray(x8)))
    xq = tq._QT(_t(x8), s_in)
    y = tops.conv(xq, 'conv', stride, padding)
    if epilogue == 'q8_relu':
        got = tops.relu(y, 'conv/out').arr
    elif epilogue == 'q8':
        got = tops.requant(y, 'conv/out').arr
    elif epilogue == 'f32_relu':
        got = tops.relu(y)
    else:
        sc = tops.requant(tops.conv(xq, 'sc', stride, 'VALID'), 'res')
        got = tops.join(y, sc, 'conv/out').arr
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_input_quantize_and_maxpool_match_jax():
    """The plain-PyTorch steps around the kernels: the uint8 input
    quantize (mean subtract, multiply by the reciprocal step) and the
    int8 3x3/2 SAME maxpool padded with -128."""
    rng = np.random.RandomState(4)
    mean = (123.7, 116.8, 103.9)
    scales = {'input': 151.3}
    jops = jq.Int8Ops({}, {}, scales, mean_pixel=mean)
    tops = tq.Int8Ops({}, {}, scales, mean_pixel=mean)
    u8 = rng.randint(0, 256, (2, 18, 22, 3)).astype(np.uint8)
    want = jax.jit(lambda x: jops.input(x).arr)(jnp.asarray(u8))
    got = tops.input(_t(u8))
    np.testing.assert_array_equal(got.arr.numpy(), np.asarray(want))
    x8 = rng.randint(-127, 128, (2, 18, 22, 8)).astype(np.int8)
    want = jax.jit(lambda x: jops.maxpool(jq._QT(x, 0.5)).arr)(
        jnp.asarray(x8))
    got = tops.maxpool(tq._QT(_t(x8), 0.5))
    np.testing.assert_array_equal(got.arr.numpy(), np.asarray(want))


def test_epilogue_arithmetic():
    """Each epilogue on hand-picked accumulators: rounding half to even,
    clipping, the residual term, the s32 passthrough."""
    acc = torch.tensor([[0, 5, -5, 1000, -1000, 3, 1]], dtype=torch.int32)
    alpha = torch.full((7,), 0.5)
    beta = torch.zeros(7)
    res = torch.tensor([[1, 1, 1, 1, 1, -8, 0]], dtype=torch.int8)
    kw = dict(alpha=alpha, beta=beta)
    assert ic.epilogue_torch(acc, 's32').tolist() == acc.tolist()
    assert ic.epilogue_torch(acc, 'f32', **kw).tolist() == \
        [[0, 2.5, -2.5, 500, -500, 1.5, 0.5]]
    assert ic.epilogue_torch(acc, 'f32_relu', **kw).tolist() == \
        [[0, 2.5, 0, 500, 0, 1.5, 0.5]]
    assert ic.epilogue_torch(acc, 'q8_relu', **kw).tolist() == \
        [[0, 2, 0, 127, 0, 2, 0]]
    assert ic.epilogue_torch(acc, 'q8', **kw).tolist() == \
        [[0, 2, -2, 127, -127, 2, 0]]
    assert ic.epilogue_torch(acc, 'join', res=res, res_scale=1.0,
                             **kw).tolist() == [[1, 4, 0, 127, 0, 0, 0]]
    # y rounds once: (2^24 - 1) * (1 + 2^-23) + 0.5 = 2^24 + 1.4999999 is
    # 2^24 + 2 with an FMA, and 2^24 when the product rounds first
    y = ic.epilogue_torch(torch.tensor([[16777215]], dtype=torch.int32),
                          'f32', alpha=torch.tensor([1 + 2.0 ** -23]),
                          beta=torch.tensor([0.5]))
    assert y.item() == 16777218.0
    with pytest.raises(ValueError):
        ic.epilogue_torch(acc, 'relu')


@pytest.mark.parametrize('m,k,n', [(7, 147, 13), (33, 1, 5), (5, 64, 1)])
def test_gemm_plain_exact_on_ragged_shapes(m, k, n):
    """float64 accumulation is exact up to the largest K of the path."""
    rng = np.random.RandomState(m)
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    b = rng.randint(-128, 128, (k, n)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = ic.gemm_s8(_t(a), ic.kernel_layout(b))
    np.testing.assert_array_equal(got.numpy(), want)
    worst = np.full((1, 9 * 512), -128, np.int8)
    big = ic.gemm_s8_torch(_t(worst), _t(worst.T.copy()))
    assert big.item() == 9 * 512 * 128 * 128


def test_kernel_layout():
    w2 = np.arange(12, dtype=np.int8).reshape(3, 4)
    t2 = ic.kernel_layout(w2)
    assert t2.shape == (3, 4) and t2.t().is_contiguous()
    np.testing.assert_array_equal(t2.numpy(), w2)
    w4 = np.arange(2 * 3 * 5 * 7).astype(np.int8).reshape(2, 3, 5, 7)
    t4 = ic.kernel_layout(w4)
    assert t4.shape == (2, 3, 5, 7) and t4.permute(3, 0, 1, 2).is_contiguous()
    np.testing.assert_array_equal(t4.numpy(), w4)
    with pytest.raises(ValueError):
        ic.kernel_layout(np.zeros((2, 2, 2), np.int8))
    assert ic.tile_for(128, 1024) == 2 and ic.tile_for(40960, 64) == 1 \
        and ic.tile_for(40960, 256) == 0


def test_xla_rounding_the_port_reproduces():
    """What the port's epilogue copies from XLA's compiled Int8Ops (on
    the CPU, where the JAX package is tested): a division by a constant
    step is a multiply by its f32 reciprocal, not a true division, and
    acc * alpha + beta is one FMA. Either difference alone changes the
    last bit of a large share of values (measured here: 42% and 25%),
    which flips requantized values at rounding ties."""
    rng = np.random.RandomState(0)
    n = 1 << 20
    x = rng.uniform(-50, 50, n).astype(np.float32)
    step = 0.7331 / 127.0
    xla = np.asarray(jax.jit(lambda v: v / step)(x))
    np.testing.assert_array_equal(xla, x * (np.float32(1) / np.float32(step)))
    assert (xla != x / np.float32(step)).mean() > 0.3

    acc = rng.randint(-2 ** 20, 2 ** 20, n).astype(np.int32)
    alpha = rng.uniform(1e-5, 1e-3, n).astype(np.float32)
    beta = rng.randn(n).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a, s, b: a.astype(jnp.float32) * s + b)(
        acc, alpha, beta))
    port = ic.fma_f32(_t(acc.astype(np.float32)), _t(alpha), _t(beta))
    np.testing.assert_array_equal(port.numpy(), xla)
    assert (xla != acc.astype(np.float32) * alpha + beta).mean() > 0.2
