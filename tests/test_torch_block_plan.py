"""The fused bottleneck block's kernel (`block_s8`,
csrc/int8_block.cu::block_s8_kernel): numpy mirrors of its index
arithmetic held against the plain version `block_s8_torch`. The mirrors
take the kernel's constants, its address expressions, byte-permute
selectors and rounding constant from the kernel's source, so an edit to
the kernel that the mirror does not follow fails here. Pure Python on the
CPU: the kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ursonet_torch.ops import int8_cuda as ic
from ursonet_torch.probes import fused_block as fb

SRC = (Path(fb.__file__).resolve().parents[1] / 'csrc'
       / 'int8_block.cu').read_text()


def kernel_constants(src):
    """{name: value} of the source's `constexpr int` declarations,
    evaluated in order (every operand is positive, so C's integer
    division is Python's floor division)."""
    env: dict = {}
    for decl in re.findall(r"constexpr int ([^;]+);", src):
        for part in decl.split(','):
            name, expr = (t.strip() for t in part.split('=', 1))
            env[name] = eval(expr.replace('/', '//'), {}, dict(env))
    return env


K = kernel_constants(SRC)


def kernel_expr(pattern):
    """The C expression the regex `pattern` captures in the kernel's
    source, as a function of keyword arguments (C and Python agree on the
    precedence of + - * << >> & ^ over non-negative ints)."""
    m = re.search(pattern, SRC, re.S)
    assert m, pattern
    code = compile('(' + m.group(1) + ')', pattern, 'eval')
    return lambda **names: eval(code, {}, {**K, **names})


# The kernel's geometry: a tile is TH x TW output pixels, its halo HH x HW
# pixels (HP rows of the first product), each 128-channel half of a ring
# stage a slot of ROWS rows of 128 bytes, m1 rows M1LD bytes apart.
TH, TW = K['TH'], K['TW']
HH, HW, HP = K['HH'], K['HW'], K['HP']
HALF = K['kHalf']
ROWS = HALF // 128
M1LD = K['kM1Ld']
STAGES = K['kStages']
# where the load thread starts the two boxes; the ldmatrix row of a lane
# and the offset of a k32 step; the residual's 16-bit word in the join;
# the stage offset a store box reads from
LOAD_START = kernel_expr(r"tma_load_4d\(dst, map, bar, 0, (.*?)\);")
LM_LANE = kernel_expr(r"const uint32_t lm_lane =\s*(.*?);")
LM_STEP = kernel_expr(r"ldmatrix_x4\(a\[ks\], lm \+ (.*?)\);")
JOIN_ROW = kernel_expr(r"const int hr = (.*?);")
JOIN_BYTE = kernel_expr(r"reinterpret_cast<uint16_t\*>\(\s*half \+ (.*?)\);")
STORE_FROM = kernel_expr(r"tma_store_4d\(map, stage \+ (.*?),\s*128 \* hf")
# the four words each staged w3 chunk is permuted from: (word, word, sel)
W3_PERMS = [('xyzw'.index(a), 'xyzw'.index(b), int(sel, 16)) for a, b, sel in
            re.findall(r"__byte_perm\(u\.([xyzw]), u\.([xyzw]), "
                       r"(0x[0-9a-fA-F]+)\)", SRC)]
MAGIC = np.float32(float(re.search(r"constexpr float kMagic = ([0-9.]+)f;",
                                   SRC).group(1)))


def block_tiles(h, w):
    """(tiles along H, tiles along W) of one image."""
    return -(-h // TH), -(-w // TW)


def tile_at(tile, h, w):
    """(image, first output row, first output column) of tile number
    `tile` of the persistent walk (raster order within an image)."""
    ty_n, tx_n = block_tiles(h, w)
    b, rem = divmod(tile, ty_n * tx_n)
    ty, tx = divmod(rem, tx_n)
    return b, ty * TH, tx * TW


def tma_boxes(b, y0, x0):
    """Start coordinates (channel, column, row, image) of the tile's two
    TMA boxes of x viewed as bytes [B][H][W][256]: the halo starts one
    pixel up and left."""
    cx, cy, cb = LOAD_START(t=SimpleNamespace(b=b, y0=y0, x0=x0))
    return [(128 * kb, cx, cy, cb) for kb in range(2)]


def sw128(row, chunk):
    """The 128-byte swizzle: 16-byte chunk `chunk` of 128-byte row `row`
    of a 1024-byte aligned tile lies at chunk chunk ^ (row % 8)."""
    return chunk ^ (row % 8)


def stage_offset(hr, n):
    """Where byte n (channel) of halo pixel hr lies in a ring stage."""
    return (n // 128) * HALF + hr * 128 + (sw128(hr, (n % 128) // 16) << 4) \
        + n % 16


def tma_stage(x, b, y0, x0, garbage=None):
    """A ring stage as the two boxes leave it: [2 * HALF] bytes, zeros
    for pixels outside the tensor, rows HP..ROWS - 1 of each half never
    written (`garbage` stands for what they hold)."""
    _, h, w, _ = x.shape
    stage = np.zeros(2 * HALF, np.int8) if garbage is None \
        else garbage.copy()
    for c0, cx, cy, cb in tma_boxes(b, y0, x0):
        for hy in range(HH):
            for hx in range(HW):
                gy, gx = cy + hy, cx + hx
                v = x[cb, gy, gx, c0:c0 + 128] if (0 <= gy < h and 0 <= gx < w) \
                    else np.zeros(128, np.int8)
                r = hy * HW + hx
                for ch in range(8):
                    dst = (c0 // 128) * HALF + r * 128 + (sw128(r, ch) << 4)
                    stage[dst:dst + 16] = v[16 * ch:16 * ch + 16]
    return stage


def a_tile(stage, kb, mt):
    """The K-major A tile a shared-memory wgmma descriptor reads from half
    kb, M tile mt: [64 rows][128 bytes] unswizzled."""
    out = np.empty((64, 128), np.int8)
    for r in range(64):
        row = mt * 64 + r
        base = kb * HALF + row * 128
        for ch in range(8):
            src = base + (sw128(row, ch) << 4)
            out[r, 16 * ch:16 * ch + 16] = stage[src:src + 16]
    return out


def ldmatrix_addr(lane, py, ks):
    """The m1 byte offset lane `lane` hands ldmatrix.x4 in k32 step ks
    (tap ks // 2, channels 32 (ks % 2) ..) for output row py."""
    ky, kx = divmod(ks // 2, 3)
    return LM_LANE(py=py, lane=lane) + LM_STEP(ky=ky, kx=kx, ks=ks)


def ldmatrix_fragments(m1, py, ks):
    """[32 lanes][4 registers][4 bytes]: what ldmatrix.x4 gives each lane
    (register q of lane l: bytes 4 (l % 4).. of row l / 4 of matrix q)."""
    rows = [m1[ldmatrix_addr(l, py, ks):ldmatrix_addr(l, py, ks) + 16]
            for l in range(32)]
    out = np.empty((32, 4, 4), np.int8)
    for lane in range(32):
        for q in range(4):
            row = rows[8 * q + lane // 4]
            out[lane, q] = row[4 * (lane % 4):4 * (lane % 4) + 4]
    return out


def fragment_to_tile(frag):
    """The [16 rows][32 bytes] A tile an m16n8k32 / register-A wgmma
    fragment [32 lanes][4][4] holds: a[0] row g bytes 4t.., a[1] row
    g + 8, a[2] and a[3] the same rows at byte 16 + 4t."""
    tile = np.empty((16, 32), np.int8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        tile[g, 4 * t:4 * t + 4] = frag[lane, 0]
        tile[g + 8, 4 * t:4 * t + 4] = frag[lane, 1]
        tile[g, 16 + 4 * t:16 + 4 * t + 4] = frag[lane, 2]
        tile[g + 8, 16 + 4 * t:16 + 4 * t + 4] = frag[lane, 3]
    return tile


def store_boxes(b, y0, x0, h):
    """The store thread's TMA boxes of a tile: (stage byte offset of the
    box, start coordinates (channel, column, row, image)) per output row
    inside the image and 128-channel half; a box is 16 rows of 128 bytes
    read from the row's first centre pixel on."""
    return [(STORE_FROM(hf=hf, oy=oy), (128 * hf, x0, y0 + oy, b))
            for oy in range(TH) if y0 + oy < h for hf in range(2)]


def store_box_read(stage, start):
    """[16 pixels][128 bytes] a TMA store box reads from `start`, with the
    128-byte swizzle taken from the shared-memory address (row r of the
    box is stage row start / 128 + r)."""
    out = np.empty((TW, 128), np.int8)
    for r in range(TW):
        row = start // 128 + r
        for ch in range(8):
            src = row * 128 + (sw128(row, ch) << 4)
            out[r, 16 * ch:16 * ch + 16] = stage[src:src + 16]
    return out


def w3_depth_order(kappa):
    """The m2 channel at depth index kappa = 32 s + 16 hf + 4 t + e of
    the last product (k32 step, half, fragment lane, byte)."""
    s, r = divmod(kappa, 32)
    hf, r = divmod(r, 16)
    t, e = divmod(r, 4)
    return 32 * s + 16 * hf + 8 * (e // 2) + 2 * t + e % 2


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on 32-bit words."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] \
        + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def stage_w3_row(row):
    """A staged w3 row's first 64 bytes: each 16-byte chunk q as the
    kernel builds it from the four words of the row's chunk q."""
    assert len(W3_PERMS) == 4
    words = row.view(np.uint32)
    out = []
    for q in range(4):
        u = [int(v) for v in words[4 * q:4 * q + 4]]
        out += [byte_perm(u[a], u[b], sel) for a, b, sel in W3_PERMS]
    return np.array(out, np.uint32).view(np.int8)


def pack_m2(q):
    """The last product's A fragments [32 lanes][2 k32 steps][4 regs][4
    bytes] a warp packs from its requantized 3x3 accumulators q [16
    rows][64 channels] (thread (g, t) holds channels 8j + 2t, + 1 of rows
    g and g + 8): register 2 hf + h of step s is the pair of block j =
    4 s + 2 hf and the pair of block j + 1, row g + 8 h."""
    out = np.empty((32, 2, 4, 4), np.int8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for s in range(2):
            for hf in range(2):
                j = 4 * s + 2 * hf
                for h in range(2):
                    r = g + 8 * h
                    out[lane, s, 2 * hf + h] = [
                        q[r, 8 * j + 2 * t], q[r, 8 * j + 2 * t + 1],
                        q[r, 8 * j + 8 + 2 * t], q[r, 8 * j + 9 + 2 * t]]
    return out


# --------------------------------------------------------------------------
# the wrapper on the CPU


def test_cpu_tensors_run_the_plain_version_uncounted():
    ops = fb.operands(1, 3, 5, 0, 'cpu')
    fb.reset_counts()
    assert torch.equal(fb.block_s8(*ops), fb.block_s8_torch(*ops))
    assert fb.launches == {'block_s8': 0}


# --------------------------------------------------------------------------
# geometry


def test_tile_geometry_and_cost():
    """The kernel's constants give the design its header states."""
    assert (TH, TW, HH, HW, HP) == (8, 16, 10, 18, 180)
    # a box is the halo's 180 rows of 128 bytes; its slot is whole wgmma
    # M tiles and keeps the next slot on 1024 bytes
    assert K['kBoxBytes'] == HP * 128 == 23040
    assert ROWS == 192 and ROWS % 64 == 0 and ROWS >= HP
    assert HALF % 1024 == 0 and K['kStageBytes'] == 2 * HALF
    assert STAGES >= 2
    # resident weights, one byte each, K padded to whole 128-byte rows
    assert K['kW1Bytes'] == 256 * 64
    assert K['kW2Bytes'] == -(-576 // 128) * 128 * 64 == 40960
    assert K['kW3Bytes'] == 256 * 128
    # 20,480 tiles at the probe's shape; 3 x 40 x 176 walks 165 (not a
    # multiple of 132 SMs)
    assert 128 * np.prod(block_tiles(128, 160)) == 20480
    assert 3 * np.prod(block_tiles(40, 176)) == 165
    # the products a tile does against an unfused block's on 128 pixels
    tile = ROWS * 256 * 64 + TH * TW * 576 * 64 + TH * TW * 64 * 256
    unfused = TH * TW * (256 * 64 + 576 * 64 + 64 * 256)
    assert 2 * tile == 19922944 and 2 * unfused == 17825792
    assert tile / unfused == pytest.approx(1.1176, abs=1e-4)
    # shared memory: slack, ring, weights, two m1 buffers, epilogue rows,
    # barriers (full, joined, empty per stage), under the 227 KB a block
    # may have
    smem = 1024 + STAGES * 2 * HALF \
        + K['kW1Bytes'] + K['kW2Bytes'] + K['kW3Bytes'] + 2 * HP * M1LD \
        + (64 + 64 + 256) * 8 + 256 * 4 + 3 * STAGES * 8
    assert smem == K['kSmemBytes'] == 222384 and smem <= 232448


@pytest.mark.parametrize('b,h,w', [(2, 13, 21), (1, 3, 5)])
def test_tile_origins_and_boxes(b, h, w):
    """Every tile of the walk: origins cover each output pixel once; the
    boxes start one pixel up and left, negative at the top and left
    borders, past the image at the bottom and right."""
    ty_n, tx_n = block_tiles(h, w)
    owner = np.zeros((b, h, w), int)
    starts = set()
    for tile in range(b * ty_n * tx_n):
        bi, y0, x0 = tile_at(tile, h, w)
        assert 0 <= bi < b and y0 % TH == 0 and x0 % TW == 0
        owner[bi, y0:y0 + TH, x0:x0 + TW] += 1
        boxes = tma_boxes(bi, y0, x0)
        assert [c for c, *_ in boxes] == [0, 128]
        for _, cx, cy, cb in boxes:
            assert (cx, cy, cb) == (x0 - 1, y0 - 1, bi)
            starts.add((cx < 0, cy < 0, cx + HW > w, cy + HH > h))
    assert (owner == 1).all()
    # every tile's halo leaves the image: on the left and top for the
    # first tiles, on the right and bottom for the last
    assert any(s[0] for s in starts) and any(s[1] for s in starts)
    assert any(s[2] for s in starts) and any(s[3] for s in starts)


def test_residual_read_is_where_the_box_put_it():
    """stage_offset of (halo pixel, channel) equals where the swizzled
    TMA box wrote that byte, for every byte of every halo pixel."""
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (1, 13, 21, 256)).astype(np.int8)
    for y0, x0 in [(0, 0), (8, 16)]:
        stage = tma_stage(x, 0, y0, x0)
        for hr in range(HP):
            gy, gx = y0 - 1 + hr // HW, x0 - 1 + hr % HW
            want = x[0, gy, gx] if (0 <= gy < 13 and 0 <= gx < 21) \
                else np.zeros(256, np.int8)
            offs = [stage_offset(hr, n) for n in range(256)]
            np.testing.assert_array_equal(stage[offs], want)
            # the two bytes of a thread's channel pair are one 16-bit word
            assert all(offs[n + 1] == offs[n] + 1 and offs[n] % 2 == 0
                       for n in range(0, 256, 2))


@pytest.mark.parametrize('py', range(TH))
def test_join_reads_the_residual_where_the_box_put_it(py):
    """The kernel's join address of each thread's channel pair (warp row
    py, lane, column block j, row half h, N half nh) is stage_offset of
    that pixel and channel."""
    for lane in range(32):
        g, t2 = lane >> 2, (lane & 3) * 2
        for h in range(2):
            hr = JOIN_ROW(py=py, g=g, h=h)
            assert hr == (py + 1) * HW + g + 8 * h + 1
            for nh in range(2):
                for j in range(16):
                    got = nh * HALF + JOIN_BYTE(hr=hr, j=j, t2=t2)
                    assert got == stage_offset(hr, 128 * nh + 8 * j + t2)


@pytest.mark.parametrize('py', range(TH))
def test_ldmatrix_rows_of_every_tap(py):
    """Lane l's address of each k32 step reaches halo row (py + ky) * 18
    + px + kx of pixel px = l % 8 + 8 (l / 8 % 2), at byte 32 (ks % 2) +
    16 (l / 16); the 8 rows of each matrix fall in 8 distinct 16-byte
    bank groups."""
    for ks in range(18):
        ky, kx = divmod(ks // 2, 3)
        addrs = [ldmatrix_addr(lane, py, ks) for lane in range(32)]
        for lane, a in enumerate(addrs):
            px = (lane & 7) + 8 * ((lane >> 3) & 1)
            assert a // M1LD == (py + ky) * HW + px + kx
            assert a % M1LD == 32 * (ks & 1) + 16 * (lane >> 4)
            assert a % 16 == 0 and a + 16 <= HP * M1LD
        for q in range(4):
            groups = {(a // 16) % 8 for a in addrs[8 * q:8 * q + 8]}
            assert len(groups) == 8


def test_ldmatrix_fragments_are_the_tap_tile():
    """The fragments ldmatrix.x4 gives a warp hold the [16 x 32] A tile
    of the tap: m1 rows of the warp's 16 pixels shifted by the tap."""
    rng = np.random.RandomState(1)
    m1 = rng.randint(0, 128, HP * M1LD).astype(np.int8)
    for py in (0, 7):
        for ks in range(18):
            ky, kx = divmod(ks // 2, 3)
            tile = fragment_to_tile(ldmatrix_fragments(m1, py, ks))
            rows = (py + ky) * HW + kx + np.arange(16)
            want = m1.reshape(HP, M1LD)[rows, 32 * (ks & 1):32 * (ks & 1) + 32]
            np.testing.assert_array_equal(tile, want)


def test_w3_depth_permutation_gives_the_same_sums():
    """The A fragments packed from the 3x3's accumulators hold m2 in the
    depth order w3_depth_order; w3 staged by byte permutes holds its K in
    the same order; the sums equal m2 @ w3 exactly."""
    order = [w3_depth_order(k) for k in range(64)]
    assert sorted(order) == list(range(64))
    rng = np.random.RandomState(2)
    q = rng.randint(0, 128, (16, 64)).astype(np.int8)          # m2, a warp
    w3 = rng.randint(-127, 128, (256, 64)).astype(np.int8)     # [N][K]
    frags = pack_m2(q)
    a = np.concatenate([fragment_to_tile(frags[:, s]) for s in range(2)],
                       axis=1)                                 # [16][64]
    np.testing.assert_array_equal(a, q[:, order])
    staged = np.stack([stage_w3_row(w3[n]) for n in range(256)])
    np.testing.assert_array_equal(staged, w3[:, order])
    got = a.astype(np.int64) @ staged.astype(np.int64).T
    np.testing.assert_array_equal(got, q.astype(np.int64) @ w3.T.astype(
        np.int64))


# --------------------------------------------------------------------------
# a numpy walk of the 'tma' kernel's tiles


def _epi(acc, a, b):
    """q8_relu at a unit step, as the plain version rounds it."""
    return ic.epilogue_torch(torch.from_numpy(acc), 'q8_relu', a, b).numpy()


def block_mirror(x, w1, w2, w3, ab):
    """The 'tma' kernel's walk through the functions above: stage, the
    1x1 on 192 rows (rows past 180 hold garbage), m1 [180][80] with zeros
    outside the image, the 3x3 from ldmatrix fragments, the last product
    on the permuted depth, the join over the stage, the TMA store boxes
    read from the stage."""
    a1, b1, a2, b2, a3, b3, res = fb._rows(ab, 64, 256)
    xn = x.numpy()
    bsz, h, w, _ = xn.shape
    w1n = w1.t().contiguous().numpy().astype(np.int64)       # [64][256]
    w2n = w2.t().contiguous().numpy().astype(np.int64)       # [64][576]
    w3n = w3.t().contiguous().numpy()                        # [256][64]
    order = [w3_depth_order(k) for k in range(64)]
    w3s = np.stack([stage_w3_row(w3n[n]) for n in range(256)]).astype(
        np.int64)
    out = np.zeros_like(xn)
    rng = np.random.RandomState(3)
    ty_n, tx_n = block_tiles(h, w)
    for tile in range(bsz * ty_n * tx_n):
        bi, y0, x0 = tile_at(tile, h, w)
        stage = tma_stage(xn, bi, y0, x0,
                          garbage=rng.randint(-128, 128, 2 * HALF)
                          .astype(np.int8))
        # the 1x1 256 -> 64 on the 192 rows of the slot
        acc1 = np.concatenate([
            np.concatenate([a_tile(stage, kb, mt) for kb in range(2)],
                           axis=1).astype(np.int64) @ w1n.T
            for mt in range(3)])
        m1v = _epi(acc1[:HP], a1, b1)
        hy, hx = np.divmod(np.arange(HP), HW)
        gy, gx = y0 - 1 + hy, x0 - 1 + hx
        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        m1 = np.zeros((HP, M1LD), np.int8)
        m1[:, :64] = np.where(inside[:, None], m1v, 0)
        m1 = m1.reshape(-1)
        for py in range(TH):
            # the 3x3, one warp's 16 pixels, k32 step by k32 step
            acc2 = np.zeros((16, 64), np.int64)
            for ks in range(18):
                a = fragment_to_tile(ldmatrix_fragments(m1, py, ks))
                acc2 += a.astype(np.int64) @ w2n[:, 32 * ks:32 * ks + 32].T
            q = _epi(acc2, a2, b2)
            frags = pack_m2(q)
            a = np.concatenate([fragment_to_tile(frags[:, s])
                                for s in range(2)], axis=1)
            acc3 = a.astype(np.int64) @ w3s.T                 # [16][256]
            # the join over the stage's centre pixels
            for px in range(TW):
                hr = (py + 1) * HW + px + 1
                offs = np.array([stage_offset(hr, n) for n in range(256)])
                r = torch.from_numpy(stage[offs].copy())
                y = ic.fma_f32(torch.from_numpy(acc3[px]).to(torch.float32),
                               a3, b3)
                y = torch.clamp_min(y + r.to(torch.float32) * res, 0.0)
                stage[offs] = torch.clamp(torch.round(y), 0, 127).to(
                    torch.int8).numpy()
        # the store thread: a box per output row and half, clipped at the
        # image's right edge
        for start_, (c0, cx, cy, cb) in store_boxes(bi, y0, x0, h):
            assert start_ % 128 == 0
            box = store_box_read(stage, start_)
            n = min(TW, w - cx)
            out[cb, cy, cx:cx + n, c0:c0 + 128] = box[:n]
        assert order == [w3_depth_order(k) for k in range(64)]
    return torch.from_numpy(out)


@pytest.mark.parametrize('b,h,w', [(2, 13, 21), (1, 3, 5)])
def test_tile_walk_mirror_matches_plain(b, h, w):
    """Ragged tiles on every border and an image smaller than a tile:
    bit for bit."""
    ops = fb.operands(b, h, w, b * h + w, 'cpu')
    want = fb.block_s8_torch(*ops)
    got = block_mirror(*ops)
    assert torch.equal(got, want)
    assert int(want.max()) > 0


# --------------------------------------------------------------------------
# the epilogue's rounding off the conversion unit


def q8_bits(z):
    """The kernel's clip(rint(z), 0, 127): the low byte of the bits of
    min(max(z, 0), 127) + 1.5 * 2^23."""
    z = np.minimum(np.maximum(np.asarray(z, np.float32), np.float32(0)),
                   np.float32(127))
    return ((z + MAGIC).view(np.int32) & 0xFF).astype(np.int64)


def test_q8_bits_is_the_plain_clip_and_round():
    """Against clip(round-half-even(max(z, 0)), 0, 127) as the plain
    version computes it: every half-integer tie, the values next to them,
    negatives, -0.0, values far past 127."""
    ties = np.arange(-3, 130, dtype=np.float32) + np.float32(0.5)
    z = np.concatenate([
        ties, np.nextafter(ties, np.float32(np.inf)),
        np.nextafter(ties, np.float32(-np.inf)),
        np.arange(-5, 140, dtype=np.float32),
        np.float32([-0.0, 1e-30, -1e-30, 126.99999, 127.00001, 1e9, -1e9]),
        np.random.RandomState(4).uniform(-50, 200, 100000).astype(
            np.float32)])
    want = torch.clamp(torch.round(torch.clamp_min(torch.from_numpy(z),
                                                   0.0)), 0, 127)
    np.testing.assert_array_equal(q8_bits(z), want.numpy().astype(np.int64))


@pytest.mark.parametrize('seed', range(3))
def test_join_arithmetic_matches_the_plain_join(seed):
    """The join of the kernel (one FMA, the residual product and the sum
    each rounded, q8_bits) against block_s8_torch's, on accumulators
    spread over the last product's range."""
    rng = np.random.RandomState(seed)
    acc = rng.randint(-64 * 127 * 128, 64 * 127 * 127, 200000)
    x = rng.randint(-128, 128, acc.size)
    a = np.float32(3e-4)
    b = (rng.randn(acc.size) * 5.0).astype(np.float32)
    res = np.float32(0.11)
    y = ic.fma_f32(torch.from_numpy(acc.astype(np.float32)),
                   torch.tensor(a), torch.from_numpy(b)).numpy()
    r = x.astype(np.float32) * res
    got = q8_bits(y + r)
    want = torch.clamp(torch.round(torch.clamp_min(
        ic.fma_f32(torch.from_numpy(acc.astype(np.float32)), torch.tensor(a),
                   torch.from_numpy(b))
        + torch.from_numpy(x.astype(np.float32)) * float(res), 0.0)), 0, 127)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    assert 0 < (got > 0).mean() < 1 and (got == 127).any()
