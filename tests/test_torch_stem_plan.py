"""What the Hopper routes of the fused stem (`stem_s8`, csrc/int8_stem.cu)
and of the rate loops (`mma_rate`, csrc/mma_rate.cu) decide on the host,
and numpy mirrors of the kernels' index arithmetic held against the plain
versions. Pure Python on the CPU: the kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import chip_smoke
from ursonet_torch.ops import int8_cuda as ic
from ursonet_torch.probes import int4_mma, int8_mma
from ursonet_torch.probes import mma_rate as mr
from ursonet_torch.probes import stem as stem_probe

# The 'tma' stem kernel's geometry, as csrc/int8_stem.cu fixes it: a tile
# is TPH x TPW pooled pixels, its GEMM the CR x CW conv pixels under them
# (halo included), padded to whole 64-row chunks of a wgmma, its staged
# input IR x IC packed pixels.
TPH, TPW = 8, 16
CR, CW = 2 * TPH + 1, 2 * TPW + 1
IR, IC = CR + 3, CW + 3
# A TMA box starts on a 16-byte boundary: the tile's IC * 3 words lie
# `shift` words into a box of BOX_WORDS (120 rather than 112: 24 mod 32
# banks between staged rows).
BOX_WORDS = 120


def stem_tiles(h2, w2):
    """(tiles along H, tiles along W) of one image."""
    ph, pw = -(-h2 // 2), -(-w2 // 2)
    return -(-ph // TPH), -(-pw // TPW)


def stem_tile_origin(ty, tx, h2, w2):
    """(first conv row, first conv column, first staged input row, first
    staged input column) of tile (ty, tx) in image coordinates: the pool's
    SAME padding puts pooled pixel p over conv pixels 2p - lo .. 2p - lo
    + 2 (lo = size % 2), conv pixel r over input pixels r - 2 .. r + 1."""
    cr0 = 2 * ty * TPH - h2 % 2
    cc0 = 2 * tx * TPW - w2 % 2
    return cr0, cc0, cr0 - 2, cc0 - 2


def stem_box(ic0):
    """(first word of the tile's TMA box, shift of its first pixel into
    it): the multiple of 4 words at or below word 3 * ic0."""
    w0 = (3 * ic0) // 4 * 4
    return w0, 3 * ic0 - w0


def stem_k_offset(k):
    """Byte offset of patch byte k = (ky * 4 + kx) * 12 + c from a conv
    pixel's own staged byte: 48 contiguous bytes per window row ky."""
    return (k // 48) * BOX_WORDS * 4 + k % 48


def stem_depth_order(kappa):
    """The patch byte at the GEMM's depth index kappa = 32 ks + 16 hf +
    4 t + e (k32 step, half, fragment lane, byte): 48 t + 8 ks + 4 hf + e,
    so fragment lane t reads window row ky = t alone (load_a)."""
    ks, r = divmod(kappa, 32)
    hf, r = divmod(r, 16)
    t, e = divmod(r, 4)
    return 48 * t + 8 * ks + 4 * hf + e


def stem_chunks():
    """64-row wgmma chunks of a tile's GEMM."""
    return -(-(CR * CW) // 64)


def s4_as_s8(x):
    """What the wgmma route of mma_rate stages for s4 operands: each
    int8's low nibble n sign-extended, (n ^ 8) - 8."""
    return ((x.to(torch.int16) & 0xF) ^ 8).sub(8).to(torch.int8)


# --------------------------------------------------------------------------
# stem_s8: the route


@pytest.mark.parametrize('w2,aligned,route', [
    (320, True, 'tma'),        # the flagship's packed width
    (32, True, 'tma'),         # the small serving configuration's
    (52, True, 'tma'),
    (4, True, 'tma'),
    (320, False, 'ragged'),    # a pointer off 16 bytes
    (51, True, 'ragged'),      # odd: a row is no multiple of 16 bytes
    (34, True, 'ragged'),      # W2 % 4 == 2
    (1, True, 'ragged')])
def test_stem_route(w2, aligned, route):
    assert ic.stem_route(w2, aligned) == route
    assert (w2 * 12 % 16 == 0) == (ic.stem_route(w2) == 'tma')


def test_every_served_stem_takes_the_tma_route():
    """pad64 sizes are multiples of 64, so every served packed width is a
    multiple of 32."""
    for variant in ('s2d', 'host_s2d'):
        cfg = chip_smoke.presets.serving_config(variant=variant)
        w2 = int(cfg.IMAGE_SHAPE[1]) // 2
        assert ic.stem_route(w2) == 'tma'
    assert ic.stem_route(chip_smoke.small_serving_config('s2d')
                         .IMAGE_SHAPE[1] // 2) == 'tma'


def test_stem_tile_geometry():
    # 561 conv pixels a tile in 9 chunks of 64 rows: 12.5% more products
    # than the 512 conv pixels the tile owns (halo 9.6%, padding 2.7%)
    assert (CR, CW, IR, IC) == (17, 33, 20, 36)
    assert stem_chunks() == 9 and stem_chunks() % 3 == 0
    assert CR * CW / (2 * TPH * 2 * TPW) == pytest.approx(1.0957, abs=1e-4)
    assert stem_chunks() * 64 / (CR * CW) == pytest.approx(1.0267,
                                                              abs=1e-4)
    # the TMA box: 120 words (480 bytes, a multiple of 16, at most 256
    # elements) x 20 rows holds the tile's 108 words at any shift 0..3
    box = BOX_WORDS
    assert box <= 256 and box * 4 % 16 == 0 and box >= IC * 3 + 3
    assert stem_tiles(256, 320) == (16, 10)          # 20,480 at batch 128
    assert stem_tiles(37, 52) == (3, 2)


def test_stem_k_offset_walks_48_contiguous_bytes_per_ky():
    offs = [stem_k_offset(k) for k in range(192)]
    row = BOX_WORDS * 4
    for ky in range(4):
        run = offs[48 * ky:48 * (ky + 1)]
        assert run == list(range(ky * row, ky * row + 48))
    # a 4-byte A fragment never straddles two ky rows
    assert all(offs[k + 3] - offs[k] == 3 for k in range(0, 192, 4))


def test_stem_depth_order_gives_each_lane_one_window_row():
    """A permutation of the depth; fragment lane t's 24 fragment bytes of
    a pixel (12 words over the six k32 steps) are the 48 contiguous bytes
    of window row ky = t, in order; the 32 lanes' words of one load hit
    32 distinct banks."""
    order = [stem_depth_order(k) for k in range(192)]
    assert sorted(order) == list(range(192))
    for t in range(4):
        lane = [order[32 * ks + 16 * hf + 4 * t + e] for ks in range(6)
                for hf in range(2) for e in range(4)]
        assert lane == list(range(48 * t, 48 * t + 48))
    row_words = BOX_WORDS
    banks = {(3 * g + row_words * t) % 32 for g in range(8) for t in range(4)}
    assert len(banks) == 32


# --------------------------------------------------------------------------
# stem_s8: a numpy mirror of the tma kernel's tile walk


def _table(mode, mean, inv_s_in):
    """The kernel's quantize table [12, 256] and fill values [12]."""
    v = torch.arange(256, dtype=torch.uint8)[:, None].expand(256, 12)
    q, fill = ic.stem_input_s8(v.contiguous(), mode, mean, inv_s_in)
    return q.numpy().T.copy(), fill.numpy()


@pytest.mark.parametrize('ic0', range(-4, 40))
def test_stem_box_starts_on_16_bytes(ic0):
    w0, shift = stem_box(ic0)
    assert w0 % 4 == 0 and 0 <= shift <= 3 and w0 + shift == 3 * ic0
    assert shift + IC * 3 <= BOX_WORDS
    if ic0 >= 0:
        assert shift == 3 * ic0 % 4


def _staged(x, b, ir0, ic0, table, fill, replace=True):
    """The tile's staged pixels after TMA (zeros outside the tensor) and
    the in-place quantize: [IR, IC, 12] s8."""
    _, h2, w2, _ = x.shape
    rows, cols = ir0 + np.arange(IR), ic0 + np.arange(IC)
    inside = ((rows >= 0) & (rows < h2))[:, None] \
        & ((cols >= 0) & (cols < w2))[None, :]
    raw = np.zeros((IR, IC, 12), np.uint8)
    raw[inside] = x[b][np.clip(rows, 0, h2 - 1)][:, np.clip(cols, 0, w2 - 1)][
        inside]
    q = table[np.arange(12)[None, None, :], raw]
    if replace:
        q = np.where(inside[..., None], q, fill[None, None, :])
    return q.astype(np.int8)


def stem_mirror(x, w, alpha, beta, inv_s_out, mode, mean, inv_s_in):
    x = x.numpy()
    b, h2, w2, _ = x.shape
    table, fill = _table(mode, mean, inv_s_in)
    # the depth in the kernel's order, in A and in B
    order = np.array([stem_depth_order(k) for k in range(192)])
    wk = w.permute(3, 0, 1, 2).reshape(64, 192).numpy().astype(np.int64)
    wk = wk[:, order]
    k_off = np.array([stem_k_offset(k) for k in order])
    rows = stem_chunks() * 64
    m = np.minimum(np.arange(rows), CR * CW - 1)
    row_bytes = BOX_WORDS * 4
    base = (m // CW) * row_bytes + (m % CW) * 12
    ph, pw = -(-h2 // 2), -(-w2 // 2)
    out = np.zeros((b, ph, pw, 64), np.int8)
    ty_n, tx_n = stem_tiles(h2, w2)
    for bi in range(b):
        for ty in range(ty_n):
            for tx in range(tx_n):
                cr0, cc0, ir0, ic0 = stem_tile_origin(ty, tx, h2, w2)
                # the ring stage: rows of the TMA box, the tile's pixels
                # `shift` words in
                _, shift = stem_box(ic0)
                stage = np.zeros((IR, row_bytes), np.int8)
                stage[:, 4 * shift:4 * shift + IC * 12] = _staged(
                    x, bi, ir0, ic0, table, fill).reshape(IR, -1)
                flat = stage.reshape(-1)[4 * shift:]
                a = flat[base[:, None] + k_off[None, :]].astype(np.int64)
                acc = (a @ wk.T)[:CR * CW]            # padding rows dropped
                y = ic.epilogue_torch(torch.from_numpy(acc), 'q8_relu',
                                      alpha, beta, inv_s_out).numpy()
                gr = cr0 + np.arange(CR * CW) // CW
                gc = cc0 + np.arange(CR * CW) % CW
                inside = (gr >= 0) & (gr < h2) & (gc >= 0) & (gc < w2)
                conv = np.where(inside[:, None], y, 0).reshape(CR, CW, 64)
                for py in range(TPH):
                    for px in range(TPW):
                        gy, gx = ty * TPH + py, tx * TPW + px
                        if gy < ph and gx < pw:
                            out[bi, gy, gx] = conv[2 * py:2 * py + 3,
                                                   2 * px:2 * px + 3].max(
                                                       axis=(0, 1))
    return torch.from_numpy(out)


@pytest.mark.parametrize('mode', list(ic.STEM_MODES))
@pytest.mark.parametrize('b,h2,w2', [(1, 5, 4), (2, 37, 52), (1, 17, 36),
                                     (1, 16, 31), (1, 3, 65)])
def test_stem_tile_walk_mirror_matches_plain(b, h2, w2, mode):
    """Tiles that overhang every border, odd and even sizes (both pool
    paddings), one tile and many: bit for bit."""
    rng = np.random.RandomState(b * h2 + w2)
    x, w = chip_smoke.stem_operands('cpu', rng, b, h2, w2)
    kw = chip_smoke.stem_args(torch.device('cpu'), rng, mode)
    want = ic.stem_s8_torch(x, w, **kw)
    got = stem_mirror(x, w, **kw)
    assert torch.equal(got, want)
    assert int(want.max()) > 0


@pytest.mark.parametrize('mode', list(ic.STEM_MODES))
def test_mode_fill_replaces_tma_zeros_at_every_border(mode):
    """Each staged tile of a 2 x 3 tile image (every border and corner)
    equals the window of the plain version's padded input, and TMA's
    zeros quantized as pixels would not: a zero pixel does not quantize
    to the fill in either mode."""
    rng = np.random.RandomState(3)
    b, h2, w2 = 1, 29, 76
    x, _ = chip_smoke.stem_operands('cpu', rng, b, h2, w2)
    kw = chip_smoke.stem_args(torch.device('cpu'), rng, mode)
    q, fill_t = ic.stem_input_s8(x, mode, kw['mean'], kw['inv_s_in'])
    xp = fill_t.expand(b, h2 + 3, w2 + 3, 12).contiguous()
    xp[:, 2:h2 + 2, 2:w2 + 2] = q
    xp = xp[0].numpy()
    table, fill = _table(mode, kw['mean'], kw['inv_s_in'])
    assert (table[:, 0] != fill).all()
    ty_n, tx_n = stem_tiles(h2, w2)
    assert (ty_n, tx_n) == (2, 3)
    xn = x.numpy()
    borders = set()
    for ty in range(ty_n):
        for tx in range(tx_n):
            _, _, ir0, ic0 = stem_tile_origin(ty, tx, h2, w2)
            got = _staged(xn, 0, ir0, ic0, table, fill)
            raw = _staged(xn, 0, ir0, ic0, table, fill, replace=False)
            # staged pixel (i, j) is image pixel (ir0 + i, ic0 + j), which
            # the plain version's padded input holds at (+2, +2) for image
            # rows -2..h2 and columns -2..w2 (the conv pixels a stored
            # output reads; the tile's other cells feed only conv pixels
            # outside the image, whose values are not stored)
            i0, j0 = max(0, -2 - ir0), max(0, -2 - ic0)
            i1, j1 = min(IR, h2 + 1 - ir0), min(IC, w2 + 1 - ic0)
            want = xp[ir0 + 2 + i0:ir0 + 2 + i1, ic0 + 2 + j0:ic0 + 2 + j1]
            np.testing.assert_array_equal(got[i0:i1, j0:j1], want)
            outside = (ir0 < 0) + 2 * (ir0 + IR > h2) + 4 * (ic0 < 0) \
                + 8 * (ic0 + IC > w2)
            borders.add(outside)
            if outside:
                assert (raw[i0:i1, j0:j1] != want).any()
    # every border: top, bottom, left, right
    assert {b_ for o in borders for b_ in (1, 2, 4, 8) if o & b_} \
        == {1, 2, 4, 8}


def test_stem_entry_point(capsys):
    """The stem probe at a tiny size on the CPU: a row per route, equal
    to the plain version, then the unfused 7x7 section; a width the tma
    route does not take is recorded as unsupported."""
    rows = stem_probe.main(['--device', 'cpu', '--batch', '2', '--h', '32',
                            '--w', '64', '--reps', '1', '--check-batch', '1'])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert len(lines) == len(rows) == 3
    assert [(r['probe'], r.get('route')) for r in rows] == [
        ('stem_s8', 'tma'), ('stem_s8', 'ragged'), ('unfused-7x7', None)]
    for r in rows[:2]:
        assert r['shape'] == [2, 16, 32, 12] and r['device'] == 'cpu'
        assert r['max_lsb_diff_vs_plain'] == 0 and r['tops'] > 0
    rows = stem_probe.main(['--device', 'cpu', '--batch', '1', '--h', '12',
                            '--w', '20', '--reps', '1', '--check-batch', '1'])
    assert rows[0]['error'].startswith('unsupported')
    assert rows[1]['max_lsb_diff_vs_plain'] == 0


# --------------------------------------------------------------------------
# mma_rate: tiles and routes


PROBE_SHAPES = sorted(
    {(s, 'bf16') for s in int8_mma.SHAPES}
    | {(s, 's8') for s in int8_mma.SHAPES + int4_mma.SHAPES}
    | {(s, 's4') for s in int4_mma.SHAPES})


@pytest.mark.parametrize('kind,k,wgmma,mma_sync', [
    ('s8', 256, (128, 256), (128, 128)), ('s8', 512, (128, 256), (128, 128)),
    ('s8', 1024, (128, 64), (64, 128)),
    ('bf16', 256, (128, 256), (128, 128)),
    ('bf16', 512, (128, 64), (64, 128)),
    ('bf16', 1024, (64, 32), (32, 64)),
    ('s4', 512, (128, 256), (128, 128)),
    ('s4', 1024, (128, 64), (128, 128))])
def test_tile_for_both_routes(kind, k, wgmma, mma_sync):
    assert mr.tile_for(kind, k, 'wgmma') == wgmma
    assert mr.tile_for(kind, k) == wgmma
    assert mr.tile_for(kind, k, 'mma_sync') == mma_sync
    kb = mr.staged_row_bytes(kind, k)
    assert mr.wgmma_smem(*wgmma, kb) <= mr.SMEM_LIMIT
    # the next larger tile of the list does not fit
    i = mr.WGMMA_TILES.index(wgmma)
    assert all(mr.wgmma_smem(*t, kb) > mr.SMEM_LIMIT
               for t in mr.WGMMA_TILES[:i])


@pytest.mark.parametrize('mnk,kind', PROBE_SHAPES, ids=str)
def test_both_routes_take_every_probe_shape(mnk, kind):
    m, n, k = mnk
    for route in mr.ROUTES:
        assert mr.takes(kind, m, n, k, route)
    assert mr.rate_route(kind, m, n, k) == 'wgmma'
    bm, bn = mr.tile_for(kind, k, 'wgmma')
    tiles = (m // bm) * (n // bn)
    assert tiles * mr.default_replicas(tiles, 132) % 132 == 0


def test_rate_route_by_shape():
    assert mr.rate_route('s8', 128, 128, 128) == 'mma_sync'  # N < 256
    assert mr.rate_route('s8', 128, 256, 128) == 'wgmma'
    assert mr.rate_route('s8', 128, 256, 64) == 'mma_sync'   # half a block
    assert not mr.takes('s8', 128, 256, 96, 'wgmma')         # K % 128
    assert mr.takes('bf16', 64, 32, 1024, 'wgmma')
    assert not mr.takes('bf16', 64, 32, 1024, 'mma_sync')    # N % 64
    assert not mr.takes('bf16', 32, 64, 1024, 'wgmma')       # M < 64
    assert mr.takes('bf16', 32, 64, 1024, 'mma_sync')
    assert not mr.takes('s4', 128, 128, 32, 'mma_sync')      # K % 64
    assert mr.takes('s4', 128, 256, 128, 'wgmma')
    assert not mr.takes('bf16', 64, 32, 4096, 'wgmma')       # too deep
    with pytest.raises(ValueError):
        mr.tile_for('s8', 512, 'tma')


def test_s4_sign_extension_mirror_equals_plain():
    """The wgmma route's staging of s4 operands, then the s8 loop: the
    plain s4 version exactly, for any int8 bytes (only the low nibble
    counts), int32 wrap included."""
    rng = np.random.RandomState(5)
    for m, n, k, iters in [(64, 32, 96, 3), (128, 256, 512, 1 << 20)]:
        a = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.randint(-128, 128, (k, n)).astype(np.int8))
        want = mr.mma_rate_torch(a, b, iters, 's4')
        got = mr.mma_rate_torch(s4_as_s8(a), s4_as_s8(b), iters, 's8')
        assert torch.equal(got, want)
    x = torch.arange(-128, 128, dtype=torch.int8)
    assert s4_as_s8(x).tolist() == [((v + 8) % 16) - 8 for v in
                                       range(-128, 128)]


def _stage_sw128(rows_bytes):
    """The wgmma route's staging: row r's 16-byte chunk c at K-block c//8,
    chunk (c % 8) ^ (r % 8) of its 128-byte row."""
    rows, kb = rows_bytes.shape
    blocks = -(-kb // 128)
    smem = np.zeros(blocks * rows * 128, np.uint8)
    for r in range(rows):
        for c in range(kb // 16):
            dst = (c // 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) * 16)
            smem[dst:dst + 16] = rows_bytes[r, 16 * c:16 * c + 16]
    return smem


@pytest.mark.parametrize('rows,kb', [(64, 32), (128, 512), (256, 96),
                                     (64, 2048)])
def test_wgmma_steps_read_back_the_staged_rows(rows, kb):
    """What the descriptor of k-step s reads (start = K-block s // 4 at
    32 * (s % 4) bytes; row r's 16-byte chunk j of the step at chunk
    (2 * (s % 4) + j) ^ (r % 8)) is bytes 32s..32s+31 of each row."""
    rng = np.random.RandomState(rows + kb)
    src = rng.randint(0, 256, (rows, kb)).astype(np.uint8)
    smem = _stage_sw128(src)
    for s in range(kb // 32):
        blk = (s // 4) * rows * 128
        for r in range(rows):
            got = np.concatenate([
                smem[blk + r * 128 + (((2 * (s % 4) + j) ^ (r % 8)) * 16):][:16]
                for j in range(2)])
            np.testing.assert_array_equal(got, src[r, 32 * s:32 * s + 32])
