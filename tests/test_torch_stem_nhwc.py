"""The fused stem's 'nhwc' route (`stem_s8` on the raw uint8 batch, the
`base` and `s2d` variants' served stem section) on the CPU: its plain
version against the JAX package's `Int8Ops` stem section and against the
packed route's plain version, a numpy mirror of the kernel's staging
(TMA boxes over the raw rows, the raw -> packed map, the border fill),
and the route and `Int8Ops` dispatch, decided from the shapes.

Tolerances: all exact (integers, and the same f32 roundings as the JAX
package's XLA computation)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_stem_plan import IC, IR, TPH, TPW, _staged, _table, \
    stem_mirror, stem_tile_origin, stem_tiles
from torch_parity import small_configs
from ursonet_tpu.models import quant as jq
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.models import quant as tq
from ursonet_torch.models.resnet import space_to_depth2, stem_kernel_to_s2d
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import int8_cuda as ic

SRC = (Path(ic.__file__).resolve().parent.parent / 'csrc' / 'int8_stem.cu') \
    .read_text()
MEAN3 = np.array([123.7, 116.8, 103.9], np.float32)


def _const(name):
    """A constant of csrc/int8_stem.cu, its expression evaluated."""
    expr = re.search(rf'constexpr int {name} = ([^;]+);', SRC).group(1)
    return eval(expr, {'IR': IR})


# the 'nhwc' route's TMA box: RAW_ROWS raw rows of RAW_ROW bytes
RAW_ROW, RAW_ROWS = _const('kRawRow'), _const('kRawRows')
BOX_WORDS = _const('kBoxWords')


def _raw_case(seed, b, h, w):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    w7 = rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    sw = rng.uniform(0.001, 0.01, 64).astype(np.float32)
    bias = rng.uniform(-1, 1, 64).astype(np.float32)
    return x, w7, sw, bias


# --------------------------------------------------------------------------
# the plain version


@pytest.mark.parametrize('acc', ['f32', 'bf16'])
@pytest.mark.parametrize('b,h,w', [(2, 34, 48), (1, 18, 32), (2, 70, 16)])
def test_nhwc_plain_matches_jax_stem_section(b, h, w, acc):
    """stem_s8_nhwc_torch on the raw batch is the JAX package's Int8Ops
    stem section (input quantize -> 7x7/2 conv -> relu requant ->
    maxpool), and the port's Int8Ops takes it for the raw batch: bit for
    bit in both accumulation modes, on images whose last tiles are
    ragged."""
    x, w7, sw, bias = _raw_case(b * h + w, b, h, w)
    scales = {'input': 139.3, 'conv1/out': 21.7}
    jdt = jnp.bfloat16 if acc == 'bf16' else jnp.float32
    tdt = torch.bfloat16 if acc == 'bf16' else torch.float32
    jops = jq.Int8Ops({'conv1': (jnp.asarray(w7), jnp.asarray(sw),
                                 jnp.asarray(bias))}, {}, scales,
                      acc_dtype=jdt, mean_pixel=MEAN3)
    y = jops.conv(jops.input(jnp.asarray(x)), 'conv1', 2, [(3, 3), (3, 3)])
    want = np.asarray(jax.jit(
        lambda: jops.maxpool(jops.relu(y, 'conv1/out')).arr)())
    s_in, s_out = scales['input'] / 127.0, scales['conv1/out'] / 127.0
    kw = dict(inv_s_out=tq.Int8Ops._inv(s_out), mode='calibrated',
              mean=MEAN3, inv_s_in=tq.Int8Ops._inv(s_in), acc_dtype=tdt)
    alpha = torch.from_numpy(sw) * torch.tensor(np.float32(s_in))
    w7t = ic.kernel_layout(w7)
    got = ic.stem_s8_nhwc_torch(torch.from_numpy(x), w7t, alpha,
                                torch.from_numpy(bias), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).mean() > 0.2
    # the port's Int8Ops on the raw batch: the fused stem's route
    q = {'conv1': (w7t, torch.from_numpy(sw), torch.from_numpy(bias))}
    tops = tq.Int8Ops(q, {}, scales, mean_pixel=MEAN3, acc_dtype=tdt)
    xin = tops.input(torch.from_numpy(x))
    assert isinstance(xin, tq._U8NHWC)
    out = tops.maxpool(tops.relu(tops.conv(xin, 'conv1', 2, [(3, 3), (3, 3)]),
                                 'conv1/out'))
    assert out.scale == s_out
    np.testing.assert_array_equal(out.arr.numpy(), want)


@pytest.mark.parametrize('mode', list(ic.STEM_MODES))
@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
def test_nhwc_plain_matches_packed_plain_and_wrapper(mode, acc):
    """The 7x7 chain on the raw batch equals the packed route's plain
    version on space_to_depth2(x) with the rewritten kernel, in both input
    modes (shift128's fill is not 0), and the wrapper on a CPU tensor runs
    it from the s2d kernel (`stem_kernel_7x7`, the rewrite's inverse)."""
    rng = np.random.RandomState(7)
    b, h, w = 2, 38, 80
    x, w7, w4 = chip_smoke.nhwc_operands('cpu', rng, b, h, w)
    kw = dict(chip_smoke.nhwc_args(torch.device('cpu'), rng, mode),
              acc_dtype=acc)
    want = ic.stem_s8_nhwc_torch(x, w7, **kw)
    packed = ic.stem_s8_torch(space_to_depth2(x), w4,
                              **dict(kw, mean=np.tile(kw['mean'], 4)))
    assert torch.equal(packed, want)
    assert torch.equal(ic.stem_kernel_7x7(w4), w7)
    assert torch.equal(ic.stem_s8(x, w4, **kw), want)
    assert int(want.max()) > 0


# --------------------------------------------------------------------------
# a numpy mirror of the 'nhwc' staging


def nhwc_box(ic0):
    """(first byte of the tile's TMA box in a raw row, shift of its first
    packed pixel into it): the multiple of 16 bytes at or below byte
    6 * ic0 (a packed pixel is 2 raw pixels of 3 bytes)."""
    shift = (6 * ic0) & 15
    return 6 * ic0 - shift, shift


def nhwc_staged(x, b, ir0, ic0, table, fill):
    """The tile's packed, quantized pixels [IR, IC, 12] as the kernel
    writes them: the TMA box (zeros outside the tensor) over raw rows
    2 * ir0 .., then for each packed pixel inside the image its 6 bytes of
    raw row 2r and 6 of row 2r + 1 through the table, the fill outside."""
    _, h, w, _ = x.shape
    rowb = w * 3
    w0, shift = nhwc_box(ic0)
    assert w0 % 16 == 0 and 0 <= shift <= 14 and shift % 2 == 0
    assert shift + IC * 6 <= RAW_ROW <= 256 and RAW_ROWS <= 256
    assert RAW_ROW % 16 == 0 and RAW_ROW * RAW_ROWS == IR * BOX_WORDS * 4
    box = np.zeros((RAW_ROWS, RAW_ROW), np.uint8)
    flat = x[b].reshape(h, rowb)
    for r in range(RAW_ROWS):
        gr = 2 * ir0 + r
        if 0 <= gr < h:
            lo, hi = max(w0, 0), min(w0 + RAW_ROW, rowb)
            if hi > lo:
                box[r, lo - w0:hi - w0] = flat[gr, lo:hi]
    h2, w2 = h // 2, w // 2
    out = np.zeros((IR, IC, 12), np.int8)
    for r in range(IR):
        for col in range(IC):
            gr, gc = ir0 + r, ic0 + col
            if 0 <= gr < h2 and 0 <= gc < w2:
                o = shift + 6 * col
                raw = np.concatenate([box[2 * r, o:o + 6],
                                      box[2 * r + 1, o:o + 6]])
                out[r, col] = table[np.arange(12), raw]
            else:
                out[r, col] = fill
    return out


@pytest.mark.parametrize('ic0', range(-4, 60))
def test_nhwc_box_starts_on_16_bytes(ic0):
    w0, shift = nhwc_box(ic0)
    assert w0 % 16 == 0 and 0 <= shift < 16 and w0 + shift == 6 * ic0
    assert shift + IC * 6 <= RAW_ROW and RAW_ROW // 4 <= 256
    assert RAW_ROWS == 2 * IR <= 256


@pytest.mark.parametrize('mode', list(ic.STEM_MODES))
@pytest.mark.parametrize('b,h,w', [(1, 58, 160), (1, 34, 48), (2, 2, 16)])
def test_nhwc_staging_mirror_equals_space_to_depth2(b, h, w, mode):
    """For every tile of images that overhang every border: the staged
    raw box, mapped to packed pixels and quantized, equals the packed
    route's staging of space_to_depth2(x) plus the mode's fill, and the
    tile walk on it gives the plain version's bits."""
    rng = np.random.RandomState(h + w)
    x, w7, w4 = chip_smoke.nhwc_operands('cpu', rng, b, h, w)
    kw = chip_smoke.nhwc_args(torch.device('cpu'), rng, mode)
    mean12 = np.tile(kw['mean'], 4)
    table, fill = _table(mode, mean12, kw['inv_s_in'])
    xn, xp = x.numpy(), space_to_depth2(x).numpy()
    h2, w2 = h // 2, w // 2
    ty_n, tx_n = stem_tiles(h2, w2)
    borders = set()
    for bi in range(b):
        for ty in range(ty_n):
            for tx in range(tx_n):
                _, _, ir0, ic0 = stem_tile_origin(ty, tx, h2, w2)
                got = nhwc_staged(xn, bi, ir0, ic0, table, fill)
                np.testing.assert_array_equal(
                    got, _staged(xp, bi, ir0, ic0, table, fill))
                borders.add((ir0 < 0) + 2 * (ir0 + IR > h2)
                            + 4 * (ic0 < 0) + 8 * (ic0 + IC > w2))
    assert {b_ for o in borders for b_ in (1, 2, 4, 8) if o & b_} \
        == {1, 2, 4, 8}
    want = ic.stem_s8_nhwc_torch(x, w7, **kw)
    got = stem_mirror(space_to_depth2(x), w4, **dict(kw, mean=mean12))
    assert torch.equal(got, want)


def test_nhwc_tiles_are_the_packed_routes():
    """The kernel template shares the tile (TPH x TPW pooled pixels) and
    the box bytes with the 'tma' route, and the source says so."""
    assert (TPH, TPW) == (8, 16)
    assert re.search(r'static_assert\(kRawRow \* kRawRows == kBoxBytes', SRC)
    assert RAW_ROW == 240 and RAW_ROWS == 40 and BOX_WORDS == 120


# --------------------------------------------------------------------------
# the route and the dispatch, from the shapes


@pytest.mark.parametrize('h,w,aligned,route', [
    (512, 640, True, 'nhwc'), (64, 64, True, 'nhwc'), (2, 16, True, 'nhwc'),
    (512, 648, True, None), (511, 640, True, None), (512, 640, False, None),
    (64, 8, True, None)])
def test_stem_route_of_the_raw_batch(h, w, aligned, route):
    assert ic.stem_route(w, aligned, 3, h) == route
    # packed pixels keep their routes
    assert ic.stem_route(w // 2, aligned) == (
        'tma' if aligned and (w // 2) % 4 == 0 else 'ragged')


def _ops(q, **kw):
    return tq.Int8Ops(q, {}, {'input': 300.0, 'conv1/out': 30.0},
                      mean_pixel=MEAN3, **kw)


def test_int8ops_dispatch_from_the_shapes():
    """A raw uint8 batch the 'nhwc' route takes goes to the fused stem
    whatever the kernel's form; one it does not take is quantized under
    `base` and packed on the device under s2d; a float batch, a capture
    pass and QUANT_BF16_STEM take the unfused chain."""
    rng = np.random.RandomState(0)
    w7 = rng.randint(-127, 128, (7, 7, 3, 8)).astype(np.int8)
    q7 = {'conv1': (ic.kernel_layout(w7), torch.full((8,), 1e-3),
                    torch.zeros(8))}
    ok = torch.from_numpy(rng.randint(0, 256, (2, 32, 48, 3), np.uint8))
    odd = torch.from_numpy(rng.randint(0, 256, (2, 32, 40, 3), np.uint8))
    for fused in (False, True):
        assert isinstance(_ops(q7, fused_stem=fused).input(ok), tq._U8NHWC)
    got = _ops(q7).input(odd)
    assert type(got) is tq._QT and got.arr.dtype == torch.int8
    assert type(_ops(q7, fused_stem=True).input(odd)) is tq._U8
    assert type(_ops(q7).input(ok.float())) is tq._QT
    ops = _ops(q7)
    ops.capture = {}
    assert type(ops.input(ok)) is tq._QT
    assert _ops(q7, bf16_stem=True).input(ok).dtype == torch.bfloat16
    # the s2d form of the 7x7 kernel is made once and kept; an s2d
    # kernel is the fused stem's as it is
    ops = _ops(q7)
    w4 = ops._stem_kernel('conv1', True)
    assert torch.equal(w4, ic.kernel_layout(stem_kernel_to_s2d(w7)))
    assert ops._stem_kernel('conv1', True) is w4
    assert ops._stem_kernel('conv1', False) is q7['conv1'][0]
    q4 = {'conv1': (w4,) + q7['conv1'][1:]}
    assert _ops(q4)._stem_kernel('conv1', True) is w4
    assert torch.equal(_ops(q4)._stem_kernel('conv1', False),
                       q7['conv1'][0])


def test_base_model_serves_the_raw_batch_through_the_fused_stem(
        monkeypatch):
    """A `base` QuantizedModel on a uint8 batch runs the 'nhwc' route's
    plain version once (the wrapper on the CPU) with the rewrite made in
    _prepared_q, and gives the bits of the same batch molded in float
    (the unfused chain); a capture pass (bias_correct) does not take it."""
    _, tcfg = small_configs()
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(4))
    tree = params_to_jax_layout(model.state_dict())
    qm = tq.QuantizedModel.from_variables(tcfg, tree['params'],
                                          tree['batch_stats'], device='cpu')
    x = np.random.RandomState(5).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    qm.calibrate(x)
    calls = []
    real = ic.stem_s8_nhwc_torch

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)
    monkeypatch.setattr(ic, 'stem_s8_nhwc_torch', spy)
    got = qm(x)
    assert calls == [(2, 64, 64, 3)]
    assert set(qm._stem_w4) == {'conv1'}
    assert qm._stem_w4['conv1'].shape == (4, 4, 12, 64)
    molded = x.astype(np.float32) - np.asarray(tcfg.MEAN_PIXEL, np.float32)
    unfused = qm(molded)
    assert len(calls) == 1
    for k in got:
        assert torch.equal(got[k], unfused[k]), k
    plain = qm(x, plain=True)
    assert len(calls) == 2
    for k in got:
        assert torch.equal(got[k], plain[k]), k
    qm.bias_correct(x, passes=1)
    assert len(calls) == 2
