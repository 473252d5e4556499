"""Numpy mirrors of the TRAIN_ACT_Q8 kernels' index arithmetic
(`ursonet_torch/csrc/actq.cu`), held against the plain versions of
`ursonet_torch/ops/actq_cuda.py`; no JAX, no card.

  * wgrad_s8's route choice, and on the 'tma' route its tile walk (the
    kernel's `decode`: tiles of 128 Co rows x 128 channels of one tap,
    K split into parts) covering every (co, ci, tap, k) exactly once,
    and its 5-D patch boxes over q's layout, one a output row, read
    through the k32 steps' descriptors, giving the rows of
    `im2col_torch` (stride, padding, column copies, the views of 1x1 convs);
  * quant_s8's schedule (`quant_plan`: one chunk of rows a block, at
    most one block a SM, no dynamic shared memory) covering every row
    once, and the per-unit address arithmetic of its quantize
    giving `to_layout` and `_qgt`;
  * the 'dequant' kernel's schedule (`dequant_plan`: persistent blocks,
    at most the resident ones, an unaligned head and a tail one element
    a thread, 16-element chunks between them) covering every element
    once, on the card's SMs and on one (many passes a block), each
    element's product reading its own sample's scale where a chunk spans
    samples, giving `dequant_torch`'s bits.
The geometries: the F16 flagship's 29 stage-4/5 convs (ResNet-50,
batch 32, 512x640; the box mirror at batch 2, the same widths), config
5's convs from 128x160 and 64x80 (ResNet-101, batch 16; the box mirror
at batch 2) and config 2's (ResNet-18, batch 1: basic blocks, the stem
on the gather route), the probe's CHECK geometries and odd shapes. The kernel's
constants are read from the source, so an edit there that the mirrors
do not follow fails here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ursonet_torch import presets
from ursonet_torch.ops import actq_cuda as aq
from ursonet_torch.probes import actq_wgrad8 as aw

SRC = (Path(__file__).resolve().parents[1] / 'ursonet_torch' / 'csrc'
       / 'actq.cu').read_text()
SMS = 132


def _const(name):
    m = re.search(rf'constexpr int {name} = ([^;]+);', SRC)
    assert m, name
    return m.group(1)


def _int_const(name):
    return int(eval(_const(name).split('//')[0], {}, {}))


FLAGSHIP = {nm: g for nm, (g, _) in aw.flagship_geometries(32).items()}
SMALL = {nm: g for nm, (g, _) in aw.flagship_geometries(2).items()}
ODD = {'ci64_3x3s1': (3, 9, 13, 64, 200, 3, 1, 1),
       'ci256_3x3s1': (2, 7, 9, 256, 200, 3, 1, 1),
       'ci96_3x3s2': (2, 11, 9, 96, 40, 3, 2, 1),
       '1x1s2_odd': (2, 10, 14, 128, 72, 1, 2, 0),
       '1x1s1_view': (3, 7, 9, 192, 64, 1, 1, 0),
       '5x5s3': (2, 20, 23, 64, 64, 5, 3, 2),
       'wide_row': (1, 4, 300, 64, 32, 3, 1, 1),
       's2d_pads': (2, 11, 11, 64, 6, 4, 1, ((2, 1), (2, 1)))}
STEM2 = (1, 512, 640, 3, 64, 7, 2, 3)     # config 2's stem at batch 1
# chip_smoke.py phase 8g's recipes on the int8 route: config 5's convs
# from 128x160 and 64x80 (ResNet-101, batch 16: stage 3 and the strided
# convs into stage 4), the box mirror at batch 2 (the same widths), and
# config 2's TMA-route convs (ResNet-18, batch 1: basic blocks, their
# stride-2 3x3 convs)
C5 = {nm: g for nm, (g, _) in aw.recipe_geometries(
    presets.benchmark_config(5)).items() if g[1] >= 64}
C5_SMALL = {nm.replace('n16_', 'n2_'): (2,) + g[1:] for nm, g in C5.items()}
C2 = {nm: g for nm, (g, _) in aw.recipe_geometries(
    presets.benchmark_config(2)).items() if g[3] >= 64}
FULL = {**FLAGSHIP, **ODD, **C5, **C2}
BOXED = {**SMALL, **ODD, **C5_SMALL, **C2}


def plan_of(geom, route=None):
    n, h, w, ci, co, k, s, pad = geom
    return aq.wgrad_plan((n, ci, h, w), co, (k, k), s, aw._pads(pad), route)


def test_constants_are_the_kernels():
    assert _int_const('kThreadsQ') == aq.QUANT_THREADS
    assert _int_const('kBM') == aq.WGRAD_TILE
    assert _int_const('kBK') == aq.WGRAD_STAGE_K
    # Shape<BN>: the ring's depth by tile width, within 227 KB a block
    m = re.search(r'kStages = BN == 256 \? (\d+) : (\d+);', SRC)
    assert m and 'kSmem = 1024 + kStages * kStage + 256' in SRC
    for bn, stages in ((256, int(m.group(1))), (128, int(m.group(2)))):
        smem = 1024 + stages * (aq.WGRAD_TILE + bn) * aq.WGRAD_STAGE_K + 256
        assert smem <= 232448, bn
    assert 'bn == 256 ? launch<256>' in SRC
    # the quantize's shared memory: its static arrays alone, no dynamic
    # part (one block a SM co-resident for the grid barrier)
    assert 'kernel<<<grid, kThreadsQ, 0, st>>>(p)' in SRC
    assert 'extern __shared__' not in SRC.split('namespace quant {')[1] \
        .split('}  // namespace quant')[0]
    assert 4 * (aq.QUANT_THREADS // 32 + _int_const('kScales') + 1) <= 49152
    # the row widths the boxes and the descriptors take (desc_sw's layout
    # types: 128-, 64- and 32-byte swizzles)
    assert '(wop == 32 || wop == 64 || (wop > 0 && wop % kBK == 0))' in SRC
    assert aq.WGRAD_MIN_WOP == 32


def test_routes_follow_the_shapes():
    for nm, g in FLAGSHIP.items():
        assert plan_of(g).route == 'tma', nm
    for g in aw.CHECK + [STEM2]:
        assert plan_of(g).route == 'ragged', g
    for g in list(ODD.values()) + list(C5.values()) + list(C2.values()):
        assert plan_of(g).route == 'tma', g
    # the recipes' int8-route convs: config 5's 93 and config 2's 21, all
    # on the TMA route but config 2's C = 3 stem, whose weight gradient
    # (1 x 256 x 320 = 81,920 columns, within the int32 guard) is gathered
    c5 = aw.recipe_geometries(presets.benchmark_config(5))
    c2 = aw.recipe_geometries(presets.benchmark_config(2))
    assert sum(n for _, n in c5.values()) == 93
    assert sum(n for _, n in c2.values()) == 21
    assert [g for g, _ in c2.values() if plan_of(g).route == 'ragged'] \
        == [STEM2]
    with pytest.raises(ValueError, match='tma route'):
        plan_of(aw.CHECK[0], 'tma')
    # forcing the ragged route gives the dense layouts of a call without
    # a plan
    p = plan_of(FLAGSHIP['res4_branch2b'], 'ragged')
    assert (p.hok, p.wok, p.wst, p.kps, p.copies, p.wph) == (32, 40, 40,
                                                            1280, 1, 40)
    assert p.kp == aq.padded_k(32 * 32 * 40) and p.plain_q


def test_flagship_layouts():
    """The layouts the flagship's convs get: a 3x3 conv's input as three
    column-copy planes of 48-byte rows (Wo 40; K 1536 a sample for 1280
    outputs) or 32-byte ones (Wo 20: 512 for 320), a 1x1 stride-2 conv's
    even columns a row (K padded to 64 a row), the 1x1 stride-1 convs'
    plain planes (K 1280, and 320 padded to 384)."""
    p = plan_of(FLAGSHIP['res4_branch2b'])
    assert (p.cmaj, p.copies, p.wph, p.wst, p.kps) == (True, 3, 48, 48,
                                                      1536)
    assert p.q_shape == (32, 256, 96, 48) and p.kp == 32 * 1536
    p = plan_of(FLAGSHIP['res5_branch2b'])
    assert (p.cmaj, p.copies, p.wph, p.kps) == (True, 3, 32, 512)
    p = plan_of(FLAGSHIP['res4a_branch1'])
    assert (p.cmaj, p.copies, p.wph, p.wst, p.kps, p.hb) == (False, 1, 48,
                                                            64, 2048, 2)
    assert p.q_shape == (32, 512, 64, 48)
    p = plan_of(FLAGSHIP['res4_branch2c'])
    assert (p.cmaj, p.kps, p.plain_q) == (True, 1280, True)
    assert p.kp == 32 * 32 * 40 and p.q_shape == (32, 256, 32, 40)
    p = plan_of(FLAGSHIP['res5_branch2a'])
    assert (p.kps, p.plain_q) == (384, True)


def test_recipe_layouts():
    """The layouts of the recipes' new plans: a 1x1 stride-2 conv from
    128x160 keeps the even columns (80 bytes a row) in rows of Wop = 128
    (`_wop(80)`), 64 output rows a sample; a 3x3 conv at 64x80 three
    column-copy planes of 80-byte rows; config 2's stride-2 3x3 convs
    three copies a row, row-major, from 128x160 into rows of 128 and from
    32x40 into rows of 32."""
    p = plan_of(C5['n16_256x128x160_k1s2_co128'])
    assert (p.cmaj, p.copies, p.wph, p.wst, p.kps, p.hb) == (False, 1, 80,
                                                            128, 8192, 1)
    assert p.q_shape == (16, 256, 128, 80) and p.kp == 16 * 8192
    p = plan_of(C5['n16_128x64x80_k3s1_co128'])
    assert (p.cmaj, p.copies, p.wph, p.kps) == (True, 3, 80, 5120)
    assert p.q_shape == (16, 128, 192, 80)
    p = plan_of(C2['n1_64x128x160_k3s2_co128'])
    assert (p.cmaj, p.copies, p.wph, p.wst, p.kps) == (False, 3, 80, 128,
                                                      8192)
    assert p.q_shape == (1, 64, 128, 240) and p.kp == 8192
    p = plan_of(C2['n1_256x32x40_k3s2_co512'])
    assert (p.cmaj, p.copies, p.wph, p.wst, p.kps, p.hb) == (False, 3, 32,
                                                            32, 512, 4)
    assert p.q_shape == (1, 256, 32, 96)
    p = plan_of(C2['n1_64x128x160_k1s1_co64'])
    assert (p.cmaj, p.plain_q, p.kps) == (True, True, 20480)


def decode(t, item):
    """The kernel's `decode` of a work item."""
    split, tile = divmod(item, t['tiles'])
    mt, nt = divmod(tile, t['n_tiles'])
    tap, cb = divmod(nt, t['cblocks'])
    k0 = split * t['kps']
    return tile, mt, tap, cb, k0, min(k0 + t['kps'], t['ksteps'])


@pytest.mark.parametrize('name', list(FULL))
def test_tiles_and_splits_cover_each_output_once(name):
    g = FULL[name]
    p = plan_of(g)
    t = aq.wgrad_tiles(p, SMS)
    bn = t['bn']
    assert bn == 128 or p.ci % 256 == 0
    # the least of the model's costs over the widths and parts it tries
    assert aq.wgrad_split_cost(t['tiles'], t['ksteps'], bn, t['splits'],
                               SMS) == min(
        aq.wgrad_split_cost(-(-p.co // 128) * p.kh * p.kw * -(-p.ci // b),
                            t['ksteps'], b, d, SMS)
        for b in ((128, 256) if p.ci % 256 == 0 else (128,))
        for d in range(1, min(t['ksteps'], aq.WGRAD_MAX_SPLITS) + 1)
        if (d - 1) * -(-t['ksteps'] // d) < t['ksteps']
        and (d == 1 or -(-p.co // 128) * p.kh * p.kw * -(-p.ci // b) * d
             <= SMS))
    # a split K runs in one round of the grid
    assert t['splits'] == 1 or t['items'] <= SMS
    assert t['grid'] <= SMS and t['items'] == t['tiles'] * t['splits']
    assert t['ksteps'] * aq.WGRAD_STAGE_K == p.kp
    # every split non-empty (the kernel's check)
    assert (t['splits'] - 1) * t['kps'] < t['ksteps']
    taps = p.kh * p.kw
    seen = np.zeros((t['m_tiles'], taps, t['cblocks'], t['ksteps']),
                    np.int32)
    out = np.zeros((p.co, p.ci, taps), np.int32)
    ends = {}
    for item in range(t['items']):
        tile, mt, tap, cb, k0, k1 = decode(t, item)
        assert k1 > k0
        seen[mt, tap, cb, k0:k1] += 1
        ends.setdefault(tile, set()).add((k0, k1))
    assert (seen == 1).all()
    for tile, parts in ends.items():
        assert len(parts) == t['splits']
        mt, nt = divmod(tile, t['n_tiles'])
        tap, cb = divmod(nt, t['cblocks'])
        out[mt * 128:(mt + 1) * 128, cb * bn:(cb + 1) * bn, tap] += 1
    assert (out == 1).all()


def patch_box(q5, j0, dx, h, c0, n, wseg, bn):
    """One of the kernel's 5-D boxes: dims (wph, kw copies, hk, c, n),
    box (wseg, 1, 1, bn, 1) at (j0, dx, h, c0, n), j0 a multiple of 16
    (TMA's rule); out-of-bounds bytes zero. Lands as [bn channels][wseg
    bytes]."""
    assert j0 % 16 == 0
    N, C, HK, KW, WPH = q5.shape
    j, c = j0 + np.arange(wseg), c0 + np.arange(bn)
    out = np.zeros((bn, wseg), np.int8)
    cv, jv = (c < C), (j < WPH)
    if 0 <= h < HK and cv.any() and jv.any():
        out[np.ix_(cv, jv)] = q5[n, c[cv], h, dx][:, j[jv]]
    return out


def plane_box(planes, ks, p, dx, dy, pt, c0, bn):
    """A copy-major stage's B operand: the kernel's 4-D box, dims (hk *
    wph, kw copies, c, n), box (128, 1, bn, 1) at ((ks % spp) * 128 +
    (dy - pt) * wph, dx, c0, n), the start a multiple of 16 (TMA's rule);
    out-of-bounds bytes zero. [bn channels][128 bytes of K]."""
    spp = p.kps // 128
    n, koff = divmod(ks, spp)
    j0 = koff * 128 + (dy - pt) * p.wph
    assert j0 % 16 == 0
    N, C, KW, PL = planes.shape
    j, c = j0 + np.arange(128), c0 + np.arange(bn)
    out = np.zeros((bn, 128), np.int8)
    cv, jv = c < C, (j >= 0) & (j < PL)
    if cv.any() and jv.any():
        out[np.ix_(cv, jv)] = planes[n, c[cv], dx][:, j[jv]]
    return out


def b_tile(q5, ks, p, dx, dy, pt, c0, bn):
    """A stage's B operand as the consumer's descriptors read it: the
    loader's hb boxes (region i: output row i of the stage) and k32 step
    kk at region 32 kk // wseg, byte 32 kk % wseg of its rows; [bn
    channels][128 bytes of K]."""
    rowg, seg = divmod(ks, p.segs)
    n, oh = divmod(rowg * p.hb, p.kps // p.wst)
    regions = [patch_box(q5, seg * p.wseg, dx,
                         (oh + i) * p.stride + dy - pt, c0, n, p.wseg, bn)
               for i in range(p.hb)]
    steps = []
    for kk in range(4):
        r, off = divmod(32 * kk, p.wseg)
        steps.append(regions[r][:, off:off + 32])
    return np.concatenate(steps, axis=1)


@pytest.mark.parametrize('name', list(BOXED))
def test_patch_boxes_are_the_im2col_rows(name):
    """Every stage's B tile the kernel's boxes load equals im2col_torch's
    rows of that tap and channel block wherever qgt's column is real
    (elsewhere qgt is zero and the box's bytes add nothing)."""
    g = BOXED[name]
    n, h, w, ci, co, k, s, pad = g
    p = plan_of(g)
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randint(-127, 128, (n, ci, h, w))
                         .astype(np.int8))
    ql = aq.to_layout(q, p).numpy()
    if p.cmaj:
        planes = ql.reshape(n, ci, p.copies, p.hk * p.wph)
    else:
        q5 = ql.reshape(n, ci, p.hk, p.copies, p.wph)
    P = aq.im2col_torch(q, (k, k), s, aw._pads(pad), p).numpy()
    assert P.shape == (ci * k * k, p.kp)
    real = aq._qgt(torch.ones((n, 1, p.ho, p.wo), dtype=torch.int8),
                   plan=p).numpy()[0].astype(bool)
    assert not P[:, ~real].any()
    taps = k * k
    pt = p.pads[0][0]
    t = aq.wgrad_tiles(p, SMS)
    bn = t['bn']
    for tap in range(taps):
        dy, dx = divmod(tap, k)
        for cb in range(t['cblocks']):
            rows = P[np.arange(cb * bn, min(ci, cb * bn + bn)) * taps
                     + tap]
            for ks in range(t['ksteps']):
                tile = plane_box(planes, ks, p, dx, dy, pt, cb * bn, bn) \
                    if p.cmaj else b_tile(q5, ks, p, dx, dy, pt, cb * bn, bn)
                cols = slice(ks * 128, ks * 128 + 128)
                m = real[cols]
                np.testing.assert_array_equal(
                    tile[:rows.shape[0], m], rows[:, cols][:, m],
                    err_msg=f"tap {tap} block {cb} stage {ks}")
                assert not tile[rows.shape[0]:].any()


# ---------------------------------------------------------------------------
# quant_s8

def flagship_inputs(b=32):
    """The distinct input shapes of the F16 flagship's 53 ResNet-50 convs
    (512x640, batch b): the stem's, then each stage's."""
    shapes = {(b, 3, 512, 640)}
    cin = 64
    for f1, f3, (hh, ww) in ((64, 256, (128, 160)), (128, 512, (64, 80)),
                             (256, 1024, (32, 40)), (512, 2048, (16, 20))):
        hi, wi = (hh, ww) if f1 == 64 else (hh * 2, ww * 2)
        shapes |= {(b, cin, hi, wi), (b, f1, hh, ww), (b, f3, hh, ww)}
        cin = f3
    return sorted(shapes)


def schedule(mode, shape, plan, esize):
    rv = aq.quant_rows(mode, shape, plan)
    return rv, aq.quant_plan(rv['rows'], rv['w'], esize,
                             aq.quant_vec(rv, esize), SMS)


QUANT_CASES = [('x', s, None) for s in flagship_inputs()] \
    + [('x', (g[0], g[3], g[1], g[2]), plan_of(g)) for g in FLAGSHIP.values()] \
    + [('g', (g[0], g[4], plan_of(g).ho, plan_of(g).wo), plan_of(g))
       for g in FLAGSHIP.values()] \
    + [('x', (g[0], g[3], g[1], g[2]), plan_of(g))
       for g in list(C5.values()) + list(C2.values())] \
    + [('g', (g[0], g[4], plan_of(g).ho, plan_of(g).wo), plan_of(g))
       for g in list(C5.values()) + list(C2.values())] \
    + [('x', (1, 3, 512, 640), None),
       ('g', (1, 64, 256, 320), plan_of(STEM2))] \
    + [('x', (3, 5, 7, 9), None), ('g', (3, 5, 7, 9), None),
       ('x', (2, 96, 11, 9), plan_of(ODD['ci96_3x3s2'])),
       ('g', (2, 40, 6, 5), plan_of(ODD['ci96_3x3s2'])),
       ('g', (3, 64, 7, 9), plan_of(ODD['1x1s1_view']))]


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('case', range(len(QUANT_CASES)))
def test_quant_chunks_cover_each_row_once(case, esize):
    """Block b's rows [b * chunk_rows, + chunk_rows) cover every row once
    with at most one block a SM; 16-byte loads start aligned, and end
    aligned at each block's last row."""
    mode, shape, plan = QUANT_CASES[case]
    rv, sc = schedule(mode, shape, plan, esize)
    rows, w = rv['rows'], rv['w']
    if mode == 'g':
        assert rows == shape[0] * shape[1] * rv['hok']
    assert sc['grid'] <= SMS and sc['grid'] * sc['chunk_rows'] >= rows
    seen = np.zeros(rows, np.int32)
    v = 16 // esize if sc['vec'] else 1
    for b in range(sc['grid']):
        ra = min(rows, b * sc['chunk_rows'])
        rb = min(rows, ra + sc['chunk_rows'])
        seen[ra:rb] += 1
        assert (ra * w) % v == 0            # 16-byte loads start aligned
        if sc['vec'] and rb < rows:
            assert ((rb - ra) * w * esize) % 16 == 0
    assert (seen == 1).all()
    # every input of the F16 flagship moves in 16-byte loads and stores
    if mode == 'x' and shape[0] == 32 and esize == 2:
        assert sc['vec']
    if sc['vec'] == 2:
        assert (rv['copies'], rv['s'], rv['pl']) == (1, 1, 0)
        assert (w * esize) % 16 == 0


def quant_layout_mirror(mode, rv, values, kp_rows=None):
    """The kernel's quantize addresses (`quant_rows`), for every row at
    once, 16 output bytes a unit (one where rows are not whole 16-byte
    units; the address arithmetic is the same): input row r, byte j of
    copy v holds column j * s + v - pl, zero outside the row, at r *
    copies * wph + v * wph + j, or with cmaj at ((nc * copies + v) * hok
    + h) * wph + j (r = nc * hok + h); 'g' rows land at qgt row co, column
    n * kps + oh * wph, and the block holding a plane's last row also
    writes the zeros after it up to the sample's kps (and, after the last
    sample, up to kp)."""
    rows, w, copies, wph = rv['rows'], rv['w'], rv['copies'], rv['wph']
    b = np.arange(copies * wph)
    v, j = b // wph, b % wph
    wcol = j * rv['s'] + v - rv['pl']
    inside = (wcol >= 0) & (wcol < w)
    src = values.reshape(rows, w)
    vals = np.where(inside, src[:, np.clip(wcol, 0, w - 1)], 0)
    r = np.arange(rows)
    if mode == 'x':
        out = np.full(rows * copies * wph, -1000, np.int16)
        if rv['cmaj']:
            nc, h = np.divmod(r, rv['hok'])
            addr = ((nc[:, None] * copies + v[None, :]) * rv['hok']
                    + h[:, None]) * wph + j[None, :]
        else:
            addr = r[:, None] * copies * wph + b[None, :]
        out[addr] = vals
        assert not (out == -1000).any()
        return out.astype(np.int8)
    out = np.full((kp_rows, rv['kp']), -1000, np.int16)
    n, rem = np.divmod(r, rv['rps'])
    co, oh = np.divmod(rem, rv['hok'])
    base = n * rv['kps'] + oh * wph
    out[co[:, None], base[:, None] + b[None, :]] = vals
    last = oh == rv['hok'] - 1
    for c, nn in zip(co[last], n[last]):
        z0 = nn * rv['kps'] + rv['hok'] * wph
        z1 = rv['kp'] if nn == rv['n'] - 1 else (nn + 1) * rv['kps']
        out[c, z0:z1] = 0
    assert not (out == -1000).any()
    return out.astype(np.int8)


@pytest.mark.parametrize('name', ['res4_branch2b', 'res4a_branch1',
                                  'res5_branch2b', 'res4_branch2c',
                                  'res5_branch2a', 'ci96_3x3s2', '5x5s3',
                                  '1x1s1_view', 's2d_pads',
                                  'n2_256x128x160_k1s2_co128',
                                  'n2_128x64x80_k3s1_co128',
                                  'n1_64x128x160_k3s2_co128',
                                  'n1_256x32x40_k3s2_co512',
                                  'n1_64x128x160_k1s1_co64'])
def test_quant_addresses_write_the_layouts(name):
    g = BOXED[name]
    n, h, w, ci, co, k, s, pad = g
    p = plan_of(g)
    rng = np.random.RandomState(1)
    q = rng.randint(-127, 128, (n, ci, h, w)).astype(np.int8)
    rv = aq.quant_rows('x', (n, ci, h, w), p)
    got = quant_layout_mirror('x', rv, q)
    want = aq.to_layout(torch.from_numpy(q), p).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    # back to plain: every column a tap reads (the others zero)
    src, inside = aq._copy_columns(p)
    read = np.zeros(p.wk, bool)
    read[src[inside].numpy()] = True
    back = aq.q_of(torch.from_numpy(want), p).numpy()
    np.testing.assert_array_equal(
        back.reshape(n, ci, p.hk, p.wk),
        q.reshape(n, ci, p.hk, p.wk) * read.astype(np.int8))
    qg = rng.randint(-127, 128, (n, co, p.ho, p.wo)).astype(np.int8)
    rv = aq.quant_rows('g', qg.shape, p)
    got = quant_layout_mirror('g', rv, qg, co)
    want = aq._qgt(torch.from_numpy(qg), plan=p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        aq.qg_of(torch.from_numpy(want), n, p.ho, p.wo, p).numpy(), qg)


def test_quant_dense_g_layout_and_plain_x():
    """Without a plan: 'x' rows of the flat sample, 'g' the dense qgt
    with its zero tail up to a multiple of 16 (the ragged route's)."""
    rng = np.random.RandomState(2)
    qg = rng.randint(-127, 128, (3, 5, 7, 9)).astype(np.int8)
    rv = aq.quant_rows('g', qg.shape)
    assert rv['kp'] == aq.padded_k(3 * 63)
    got = quant_layout_mirror('g', rv, qg, 5)
    np.testing.assert_array_equal(got, aq._qgt(torch.from_numpy(qg)).numpy())
    x = rng.randint(-127, 128, (2, 64, 32, 40)).astype(np.int8)
    rv = aq.quant_rows('x', x.shape)
    assert (rv['w'], rv['copies']) == (256, 1)
    np.testing.assert_array_equal(
        quant_layout_mirror('x', rv, x).reshape(x.shape), x)


# ---------------------------------------------------------------------------
# quant_s8 'dequant'


def test_dequant_constants_are_the_kernels():
    """The plan's constants are the kernel's, and its launch bounds keep
    the plan's blocks a SM resident at once."""
    assert _int_const('kThreadsD') == aq.DEQUANT_THREADS
    assert _int_const('kBlocksD') == aq.DEQUANT_BLOCKS
    assert _int_const('kUnrollD') == aq.DEQUANT_UNROLL
    assert _int_const('kChunk') == aq.DEQUANT_CHUNK
    assert '__launch_bounds__(kThreadsD, kBlocksD)' in SRC
    assert aq.DEQUANT_THREADS * aq.DEQUANT_BLOCKS <= 2048


def dequant_mirror(n, per, esize, q_mod, out_mod, sms):
    """The kernel's walk over a call (`dequant_plan`'s schedule): block b,
    pass k takes chunks [(k * grid + b) * span, + span) as groups of 16 /
    esize elements, thread t groups u * threads + t of them; then the
    head and the tail one element a thread. Each group's samples are the
    kernel's `products`': the first element's for the whole group where
    the group lies inside it, else each element's own.
    Returns (plan, how often each element is written, the sample whose
    scale each element's product reads)."""
    p = aq.dequant_plan(n, per, esize, q_mod, out_mod, sms)
    total, head, chunks = n * per, p['head'], p['chunks']
    assert 1 <= p['grid'] <= sms * aq.DEQUANT_BLOCKS
    assert head + aq.DEQUANT_CHUNK * chunks + p['tail'] == total
    # groups of v = 16 / esize elements: v bytes of q loaded, 16 bytes of
    # products stored; thread t's groups u * threads + t of a pass
    v = 16 // esize
    span = aq.DEQUANT_THREADS * aq.DEQUANT_UNROLL    # chunks a pass
    per_pass = span * aq.DEQUANT_CHUNK // v          # groups a pass
    groups = chunks * aq.DEQUANT_CHUNK // v
    assert per_pass % aq.DEQUANT_THREADS == 0
    u, t = np.divmod(np.arange(per_pass), aq.DEQUANT_THREADS)
    starts = [np.zeros(0, np.int64)]
    for b in range(p['grid']):
        g0 = np.arange(b * per_pass, groups, p['grid'] * per_pass)
        g = (g0[:, None] + u * aq.DEQUANT_THREADS + t).ravel()
        g = head + v * g[g < groups]
        # aligned loads of v bytes, 16-byte stores
        assert ((q_mod + g) % v == 0).all()
        assert ((out_mod + g * esize) % 16 == 0).all()
        starts.append(g)
    i0 = np.concatenate(starts)
    seen = np.zeros(total, np.int64)
    sample = np.full(total, -1, np.int64)
    n0 = i0 // per
    one = i0 + v <= (n0 + 1) * per
    for j in range(v):
        seen += np.bincount(i0 + j, minlength=total)
        sample[i0 + j] = np.where(one, n0, (i0 + j) // per)
    tail0 = head + aq.DEQUANT_CHUNK * chunks
    k = np.arange(head + total - tail0)
    i = np.where(k < head, k, tail0 + k - head)
    seen += np.bincount(i, minlength=total)
    sample[i] = i // per
    return p, seen, sample


# (shape, q's and out's bytes past a 16-byte boundary)
DQ_CASES = [((4, 64, 32, 40), 0, 0), ((5, 3, 2, 4), 0, 0),
            ((3, 5, 7, 9), 0, 0), ((70000, 1), 0, 0), ((70000, 3), 0, 0),
            ((3, 5, 7, 9), 1, 0), ((3, 5, 7, 9), 8, 0),
            ((3, 5, 7, 9), 12, 8), ((3, 5, 7, 9), 0, 4), ((2, 7), 0, 0),
            ((1, 1), 3, 0), ((4, 64, 32, 40), 14, 12),
            ((4, 64, 32, 40), 15, 12)]


@pytest.mark.parametrize('sms', [SMS, 1], ids=['card', 'one_sm'])
@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('case', range(len(DQ_CASES)))
def test_dequant_walk_covers_each_element_once(case, esize, sms):
    """Every element written once, its product from its own sample's
    scale (chunks that span samples too, down to one element a sample),
    giving dequant_torch's bits; a head of at most 15 elements where q
    and out can both be aligned, every element one a thread where they
    cannot. On one SM a block makes many passes."""
    shape, q_mod, out_mod = DQ_CASES[case]
    n, per = shape[0], int(np.prod(shape[1:]))
    p, seen, sample = dequant_mirror(n, per, esize, q_mod, out_mod, sms)
    total = n * per
    assert (seen == 1).all()
    np.testing.assert_array_equal(sample, np.arange(total) // per)
    head = -q_mod % 16
    if head < total and (out_mod + head * esize) % 16 == 0:
        assert p['head'] == head and p['tail'] < aq.DEQUANT_CHUNK
    else:
        assert (p['head'], p['chunks'], p['tail']) == (total, 0, 0)
    rng = np.random.RandomState(case)
    q = rng.randint(-128, 128, total).astype(np.int8)
    scale = (rng.rand(n) + 0.01).astype(np.float32)
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    s = torch.from_numpy(scale).to(dtype).float()
    got = (torch.from_numpy(q).float() * s[torch.from_numpy(sample)]) \
        .to(dtype)
    want = aq.dequant_torch(torch.from_numpy(q).view(shape),
                            torch.from_numpy(scale), dtype)
    assert torch.equal(got.view(shape), want)


@pytest.mark.parametrize('esize', [2, 4], ids=['bf16', 'f32'])
@pytest.mark.parametrize('shape', flagship_inputs())
def test_dequant_flagship_schedule(shape, esize):
    """The flagship's dequant calls (every conv input at batch 32): no
    head and no tail, a multiple of 16 elements a sample, so each chunk
    lies in one sample and reads one scale; the grid as many passes of
    full blocks as fit the card."""
    n, per = shape[0], int(np.prod(shape[1:]))
    assert per % aq.DEQUANT_CHUNK == 0
    span = aq.DEQUANT_THREADS * aq.DEQUANT_UNROLL
    p = aq.dequant_plan(n, per, esize, 0, 0, SMS)
    assert (p['head'], p['tail']) == (0, 0)
    assert p['chunks'] * aq.DEQUANT_CHUNK == n * per
    assert p['grid'] == min(-(-p['chunks'] // span), SMS * aq.DEQUANT_BLOCKS)
