"""A numpy mirror of the warp kernel's tile and box arithmetic
(`ursonet_torch/csrc/warp.cu`: `plan_tile` and the per-pixel taps),
held over thousands of homographies drawn in `draw_rotation`'s ranges:
every tap a tile needs lies inside the source box the kernel loads for
it, or the tile is flagged for the global path. The flagged share is
reported (and bounded at the main paths' shapes).

The mirror reads the kernel's constants (`kTile`, `kBox`, `kAlign`,
`kCoordLimit`, the box margins) from the source, so an edit of the kernel that it does
not follow fails here. The coordinates are computed in float32 in the
kernel's order of operations (each product and sum rounded, no FMA).
Pure numpy and PyTorch on the CPU; no JAX.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from ursonet_torch import se3
from ursonet_torch.ops import augment

SRC = (Path(__file__).resolve().parents[1] / 'ursonet_torch' / 'csrc'
       / 'warp.cu').read_text()


def _constexpr(name):
    m = re.search(rf"constexpr (?:int|float) {name} = ([0-9.]+)f?;", SRC)
    assert m, name
    return float(m.group(1))


TILE = int(_constexpr('kTile'))
BOX = int(_constexpr('kBox'))
ALIGN = int(_constexpr('kAlign'))    # bytes: TMA's box row start
LIMIT = np.float32(_constexpr('kCoordLimit'))
# plan_tile's margins: box from floor(min) - LO to floor(max) + HI
LO = int(re.search(r"floorf\(lox\)\) - (\d+);", SRC).group(1))
HI = int(re.search(r"floorf\(hix\)\) \+ (\d+);", SRC).group(1))

GLOBAL, BOXED, EMPTY = 'global', 'box', 'empty'


def _coords(m, x, y):
    """(sx, sy, den) in float32, each step rounded as the kernel's
    src_coord: ((m·x) + (m·y)) + m, then one division."""
    m = m.astype(np.float32)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    with np.errstate(divide='ignore', invalid='ignore'):
        den = (m[2, 0] * x + m[2, 1] * y) + m[2, 2]
        sx = ((m[0, 0] * x + m[0, 1] * y) + m[0, 2]) / den
        sy = ((m[1, 0] * x + m[1, 1] * y) + m[1, 2]) / den
    return sx, sy, den


def plan_tiles(m, h, w, epp):
    """plan_tile for every tile of one image whose rows hold `epp`
    elements a pixel (3 bytes of a u8 RGB row, 1 f32 of a plane): (kind
    [ty, tx], cx: the box's first row element, by0: its first row)."""
    align = ALIGN if epp == 3 else ALIGN // 4
    ty, tx = -(-h // TILE), -(-w // TILE)
    x0 = np.arange(tx) * TILE
    y0 = np.arange(ty) * TILE
    xs = [x0, np.minimum(x0 + TILE, w) - 1]
    ys = [y0, np.minimum(y0 + TILE, h) - 1]
    sxs, sys_, dens = [], [], []
    for k in range(4):
        sx, sy, den = _coords(m, xs[k & 1][None, :], ys[k >> 1][:, None])
        sxs.append(sx)
        sys_.append(sy)
        dens.append(den)
    with np.errstate(invalid='ignore'):
        pos = dens[0] > 0
        ok = np.ones((ty, tx), bool)
        for k in range(4):
            ok &= np.where(pos, dens[k] > 0, dens[k] < 0)
            ok &= (np.abs(sxs[k]) <= LIMIT) & (np.abs(sys_[k]) <= LIMIT)
        lox, hix = np.minimum.reduce(sxs), np.maximum.reduce(sxs)
        loy, hiy = np.minimum.reduce(sys_), np.maximum.reduce(sys_)
        lox, hix, loy, hiy = (np.where(ok, v, 0) for v in (lox, hix, loy, hiy))
    bx0 = np.floor(lox).astype(np.int64) - LO
    by0 = np.floor(loy).astype(np.int64) - LO
    bx1 = np.floor(hix).astype(np.int64) + HI
    by1 = np.floor(hiy).astype(np.int64) + HI
    cx = (bx0 * epp) & ~(align - 1)      # floors negative starts too
    assert (cx % align == 0).all() and (cx <= bx0 * epp).all()
    fits = ok & ((bx1 + 1) * epp - cx <= BOX * epp) & (by1 - by0 + 1 <= BOX)
    empty = (bx1 < 0) | (by1 < 0) | (bx0 >= w) | (by0 >= h)
    kind = np.where(~fits, GLOBAL, np.where(empty, EMPTY, BOXED))
    return kind, cx, by0


def check_image(m, h, w, epp):
    """Every tap (both interpolations' taps) of every pixel of a BOXED
    tile inside its box (every row element of the tap's pixel); no tap
    of an EMPTY tile inside the image. Returns (tiles, flagged tiles)."""
    kind, cx, by0 = plan_tiles(m, h, w, epp)
    ty, tx = kind.shape
    hp, wp = ty * TILE, tx * TILE
    sx, sy, _ = _coords(m, np.arange(wp)[None, :], np.arange(hp)[:, None])
    inside = (np.arange(hp)[:, None] < h) & (np.arange(wp)[None, :] < w)
    with np.errstate(invalid='ignore'):
        # nearest taps rint(s), bilinear floor(s) and floor(s) + 1: all
        # lie in [floor(s), floor(s) + 1]
        fx, fy = np.floor(sx), np.floor(sy)
        tiles = lambda a: a.reshape(ty, TILE, tx, TILE)  # noqa: E731
        big = np.float32(1e30)
        lo_x = np.where(inside, fx, big)
        lo_y = np.where(inside, fy, big)
        hi_x = np.where(inside, fx + 1, -big)
        hi_y = np.where(inside, fy + 1, -big)
        lo_x = tiles(lo_x).min(axis=(1, 3))
        lo_y = tiles(lo_y).min(axis=(1, 3))
        hi_x = tiles(hi_x).max(axis=(1, 3))
        hi_y = tiles(hi_y).max(axis=(1, 3))
        boxed = kind == BOXED
        assert (lo_x[boxed] * epp >= cx[boxed]).all()
        assert (lo_y[boxed] >= by0[boxed]).all()
        assert ((hi_x[boxed] + 1) * epp <= cx[boxed] + BOX * epp).all()
        assert (hi_y[boxed] < by0[boxed] + BOX).all()
        # an empty tile's taps all miss the image
        rx, ry = np.rint(sx), np.rint(sy)
        valid = inside & (((fx + 1 >= 0) & (fx <= w - 1) & (fy + 1 >= 0)
                           & (fy <= h - 1))
                          | ((rx >= 0) & (rx <= w - 1) & (ry >= 0)
                             & (ry <= h - 1)))
        assert not tiles(valid).any(axis=(1, 3))[kind == EMPTY].any()
    return kind.size, int((kind == GLOBAL).sum())


def _drawn_homographies(n, K, seed):
    """n homographies as the preprocess makes them: draw_rotation's
    draws (camera rotations of ±10° per axis above the dice's 0.5, rolls
    of ±85° below), rotation_update's M; identity samples left out."""
    draws = augment.draw_rotation(torch.Generator().manual_seed(seed), n)
    M, identity, _, _ = augment.rotation_update(
        torch.zeros(n, 3), torch.tensor([[0.0, 0, 0, 1]]).expand(n, 4), K,
        draws, True, True)
    assert not identity.any()
    return M.numpy()


# the main paths' cameras, shapes and sources: the flagship's u8 RGB rows
# (URSO at 512x640, also config 5's) and config 4's gray f32 plane (SPEED
# at 640x960); and a ragged shape in both
CASES = {
    'flagship': (lambda: chip_smoke.net_intrinsics(
        chip_smoke.flagship_config()), 512, 640, 3),
    'config4': (chip_smoke.speed_intrinsics, 640, 960, 1),
    'ragged': (lambda: np.array([[65.0, 0, 65], [0, 65.0, 50], [0, 0, 1]]),
               100, 130, 3),
}
# homographies per case (the ragged shape is small, so more of it)
DRAWS = {'flagship': 600, 'config4': 400, 'ragged': 2000}
# the largest share of flagged tiles at the main paths' shapes
MAX_FLAGGED = 0.01


@pytest.mark.parametrize('case', sorted(CASES))
def test_every_tap_of_a_boxed_tile_lies_in_its_box(case):
    K_fn, h, w, epp = CASES[case]
    Ms = _drawn_homographies(DRAWS[case], K_fn(), seed=len(case))
    tiles = flagged = 0
    for m in Ms:
        t, f = check_image(m, h, w, epp)
        tiles += t
        flagged += f
    share = flagged / tiles
    print(f"warp tiles [{case}] {len(Ms)} homographies at {h}x{w}: "
          f"{flagged} of {tiles} tiles on the global path, share {share:.6f}")
    if case != 'ragged':
        assert share <= MAX_FLAGGED


def test_degenerate_homographies_are_flagged():
    """A horizon across the image (pitch near 90°), a zero denominator
    and NaN put tiles on the global path; the boxed tiles still hold their
    taps."""
    K = chip_smoke.net_intrinsics(chip_smoke.flagship_config())
    Kinv = np.linalg.inv(K)
    cases = [K @ se3.euler2SO3_left(p, 0.0, 0.0) @ Kinv for p in (60, 80, -75)]
    cases += [K @ se3.euler2SO3_left(0.0, y, 0.0) @ Kinv for y in (70, -85)]
    singular = np.zeros((3, 3))
    singular[0, 0] = 1.0         # den = 0: infinite or NaN coordinates
    nan = np.full((3, 3), np.nan)
    flagged = 0
    for m in cases + [singular, nan]:
        for epp in (3, 1):
            _, f = check_image(np.asarray(m, np.float32), 512, 640, epp)
            flagged += f
    for m in (singular, nan):
        kind, _, _ = plan_tiles(np.asarray(m, np.float32), 512, 640, 3)
        assert (kind != BOXED).all()
    kind, _, _ = plan_tiles(np.asarray(cases[1], np.float32), 512, 640, 3)
    assert (kind == GLOBAL).any()   # the horizon crosses the image
    assert flagged > 0


def test_identity_and_small_rotations_fit_every_box():
    """The identity M and mild rotations fit every tile's box at every
    main-path shape and at a ragged one (partial edge tiles)."""
    for K_fn, h, w, _ in CASES.values():
        K = K_fn()
        Kinv = np.linalg.inv(K)
        for m in (np.eye(3), K @ se3.euler2SO3_left(1.0, -2.0, 3.0) @ Kinv):
            for epp in (3, 1):
                tiles, flagged = check_image(np.asarray(m, np.float32), h, w,
                                             epp)
                assert flagged == 0
                assert tiles == -(-h // TILE) * -(-w // TILE)
