"""Pose overlays and the inspection plots, the port of
`ursonet_tpu/ops/viz.py` (`project_points`, `axes_endpoints`,
`save_axes_overlay`, `polar_plot`, `visualize_weights`), drawn by the
port's own rasterizer (`data/synthetic.draw_segment`) and written by its
PNG encoder: the card's machine has no matplotlib.

The overlay is the frame at its own size with the ground-truth body axes
solid and the estimate's dashed (x red, y green, z blue, 2 px), and
circles of radius 8 px around the projected ground-truth (lime) and
estimated (yellow) locations. It follows the JAX package's figure, not
matplotlib's pixels.

The polar plot (`polar_plot`) is a 550 x 550 px white square (the JAX
figure's 5 x 5 in at 110 dpi) with a gray polar grid (circles at radius
0.2 .. 1.0, spokes every 45 degrees, angle 0 to the right and
counter-clockwise, as matplotlib's polar axes) and six rays from the
centre in matplotlib's default colour cycle: for pitch, yaw and roll
(`se3.quat2euler`, degrees) the ground truth solid to radius 1.0 and the
estimate dashed to radius 0.8. The PMF plot (`visualize_weights`) is a
rows x cols grid of tiles, tile k the heat map of cube[:, k*step, :]
(the first axis down, the last across) normalized by the cube's max, in
viridis. Both leave out matplotlib's text (legend, titles): the port has
no font rasterizer.
"""

from __future__ import annotations

import numpy as np

from ursonet_torch import se3
from ursonet_torch.data.png import write_png
from ursonet_torch.data.synthetic import draw_segment

AXIS_COLORS = ((255, 0, 0), (0, 128, 0), (0, 0, 255))   # matplotlib r, g, b
LIME, YELLOW = (0, 255, 0), (255, 255, 0)
LINE_PX = 2
CIRCLE_PX = 8
DASH_PX = (8, 5)           # on, off


def project_points(K, pts, frame: str = 'camera'):
    """Project 3D points to pixels through intrinsics K.

    frame='camera': optical convention (x right, y down, z forward),
    SPEED. frame='unreal': the URSO/Unreal body frame (x forward, y
    right, z down), permuted to the optical one.
    """
    pts = np.atleast_2d(np.asarray(pts, np.float64))
    if frame == 'unreal':
        cam = np.stack([pts[:, 1], pts[:, 2], pts[:, 0]], axis=1)
    else:
        cam = pts
    K = np.asarray(K, np.float64)
    uvw = cam @ K.T
    return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)


def axes_endpoints(q, loc, scale: float = 1.0):
    """Body-axis endpoints in the label frame: origin + R·(scale·eᵢ)."""
    R = se3.quat2SO3(np.asarray(q, np.float64))
    ends = [np.asarray(loc, np.float64) + np.asarray(R) @ (scale * e)
            for e in np.eye(3)]
    return np.asarray(loc, np.float64), np.stack(ends)


def draw_line(img, p0, p1, color, thickness: int = LINE_PX,
              dashed: bool = False) -> None:
    """A segment `thickness` px wide from p0 to p1 ((x, y) pixels), solid
    or dashed (DASH_PX), clipped to the image; non-finite ends draw
    nothing."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    if not (np.isfinite(p0).all() and np.isfinite(p1).all()):
        return
    # clip far-off endpoints to a box around the image: the visible part
    # is the same, the dash loop stays short
    h, w = img.shape[:2]
    lim = 4.0 * max(h, w)
    n = float(np.linalg.norm(p1 - p0))
    if n > lim:
        centre = np.array([w / 2.0, h / 2.0])
        t0 = np.dot(centre - p0, p1 - p0) / n ** 2
        mid = p0 + np.clip(t0, 0.0, 1.0) * (p1 - p0)
        u = (p1 - p0) / n
        p0 = mid - u * min(lim, float(np.linalg.norm(mid - p0)))
        p1 = mid + u * min(lim, float(np.linalg.norm(p1 - mid)))
        n = float(np.linalg.norm(p1 - p0))
    if not dashed or n == 0:
        draw_segment(img, p0, p1, color, thickness)
        return
    on, off = DASH_PX
    u = (p1 - p0) / n
    s = 0.0
    while s < n:
        draw_segment(img, p0 + u * s, p0 + u * min(s + on, n), color,
                     thickness)
        s += on + off


def _circle(img, centre, radius: float, color) -> None:
    """A ring of width LINE_PX at `radius` around `centre` (x, y)."""
    cx, cy = (float(v) for v in centre)
    if not (np.isfinite(cx) and np.isfinite(cy)):
        return
    h, w = img.shape[:2]
    r_out = radius + LINE_PX / 2.0
    xa, xb = max(int(np.floor(cx - r_out)), 0), min(int(np.ceil(cx + r_out)),
                                                    w - 1)
    ya, yb = max(int(np.floor(cy - r_out)), 0), min(int(np.ceil(cy + r_out)),
                                                    h - 1)
    if xa > xb or ya > yb:
        return
    ys, xs = np.mgrid[ya:yb + 1, xa:xb + 1].astype(np.float64)
    d = np.sqrt((xs - cx) ** 2 + (ys - cy) ** 2)
    img[ya:yb + 1, xa:xb + 1][np.abs(d - radius) <= LINE_PX / 2.0] = color


def draw_axes_overlay(image, K, loc_gt, q_gt, loc_est=None, q_est=None,
                      frame: str = None, scale: float = 1.0) -> np.ndarray:
    """The overlay as an [H, W, 3] uint8 copy of `image`."""
    frame = frame or 'unreal'
    img = np.array(image, dtype=np.uint8, copy=True)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    img = np.ascontiguousarray(img[..., :3])

    def draw(loc, q, dashed):
        origin, ends = axes_endpoints(q, loc, scale)
        o2 = project_points(K, origin[None], frame)[0]
        e2 = project_points(K, ends, frame)
        for i, c in enumerate(AXIS_COLORS):
            draw_line(img, o2, e2[i], c, dashed=dashed)

    draw(loc_gt, q_gt, False)
    if loc_est is not None:
        draw(loc_est, q_est, True)
        g = project_points(K, np.asarray(loc_gt)[None], frame)[0]
        e = project_points(K, np.asarray(loc_est)[None], frame)[0]
        _circle(img, g, CIRCLE_PX, LIME)
        _circle(img, e, CIRCLE_PX, YELLOW)
    return img


def save_axes_overlay(image, K, loc_gt, q_gt, loc_est=None, q_est=None,
                      path='overlay.png', frame: str = None,
                      scale: float = 1.0):
    """Ground-truth (solid) and estimated (dashed) pose axes over the
    image, written as a PNG at the image's size."""
    write_png(path, draw_axes_overlay(image, K, loc_gt, q_gt, loc_est,
                                      q_est, frame, scale))
    return path


# ---------------------------------------------------------------------------
# inspection plots

POLAR_PX = 550              # 5 in at 110 dpi
POLAR_RADIUS_PX = 240       # radius 1.0
GRID = (200, 200, 200)
# matplotlib's default colour cycle, C0 .. C5
CYCLE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
         (148, 103, 189), (140, 86, 75))
EULER_NAMES = ('pitch', 'yaw', 'roll')


def polar_rays(q_gt, q_est):
    """The polar plot's rays in drawing order: (label, angle in radians,
    radius, dashed, colour), for each Euler angle the ground truth then
    the estimate."""
    pyr_gt = np.asarray(se3.quat2euler(np.asarray(q_gt, np.float64)))
    pyr_est = np.asarray(se3.quat2euler(np.asarray(q_est, np.float64)))
    rays = []
    for i, name in enumerate(EULER_NAMES):
        rays.append((f"{name} gt", float(np.deg2rad(float(pyr_gt[i]))), 1.0,
                     False, CYCLE[2 * i]))
        rays.append((f"{name} est", float(np.deg2rad(float(pyr_est[i]))),
                     0.8, True, CYCLE[2 * i + 1]))
    return rays


def polar_point(angle: float, radius: float):
    """(x, y) pixel of a polar coordinate (radius 1.0 = POLAR_RADIUS_PX)."""
    c = POLAR_PX / 2.0
    r = radius * POLAR_RADIUS_PX
    return np.array([c + r * np.cos(angle), c - r * np.sin(angle)])


def draw_polar(q_gt, q_est) -> np.ndarray:
    """The polar plot as an [H, W, 3] uint8 image."""
    img = np.full((POLAR_PX, POLAR_PX, 3), 255, np.uint8)
    centre = polar_point(0.0, 0.0)
    ys, xs = np.mgrid[0:POLAR_PX, 0:POLAR_PX].astype(np.float64)
    d = np.sqrt((xs - centre[0]) ** 2 + (ys - centre[1]) ** 2)
    for r in (0.2, 0.4, 0.6, 0.8, 1.0):
        img[np.abs(d - r * POLAR_RADIUS_PX) <= 0.5] = GRID
    for k in range(8):
        draw_segment(img, centre, polar_point(k * np.pi / 4, 1.0), GRID, 1)
    for _, angle, radius, dashed, color in polar_rays(q_gt, q_est):
        draw_line(img, centre, polar_point(angle, radius), color,
                  dashed=dashed)
    return img


def polar_plot(q_gt, q_est, path='polar.png'):
    """Ground-truth and estimated Euler angles on a polar chart, written
    as a PNG."""
    write_png(path, draw_polar(q_gt, q_est))
    return path


# viridis at 0, 1/8, ..., 1 (matplotlib's table), linearly interpolated
_VIRIDIS = np.array([
    (68, 1, 84), (71, 44, 122), (59, 81, 139), (44, 113, 142),
    (33, 144, 141), (39, 173, 129), (92, 200, 99), (170, 220, 50),
    (253, 231, 37)], np.float64)
TILE_CELL_PX = 8            # a bin's square in a tile
TILE_GAP_PX = 4             # white space between tiles


def viridis(v) -> np.ndarray:
    """uint8 RGB of values in [0, 1] (clipped)."""
    v = np.clip(np.asarray(v, np.float64), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(np.floor(v).astype(int), len(_VIRIDIS) - 2)
    f = (v - i)[..., None]
    return np.rint(_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f) \
        .astype(np.uint8)


def weight_tiles(pmf, nr_bins_per_dim: int, max_slices: int = 16):
    """(rows, cols, step, tiles) of the PMF plot: the flat PMF zero-padded
    to the full cube (masked bins may be missing), tile k = cube[:, k *
    step, :] / max(cube) (max 0: 1)."""
    pmf = np.asarray(pmf, np.float64).ravel()
    full = nr_bins_per_dim ** 3
    if pmf.size < full:
        buf = np.zeros(full)
        buf[:pmf.size] = pmf
        pmf = buf
    cube = pmf[:full].reshape((nr_bins_per_dim,) * 3)
    n = min(nr_bins_per_dim, max_slices)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    step = max(1, nr_bins_per_dim // n)
    vmax = cube.max() or 1.0
    return rows, cols, step, [cube[:, k * step, :] / vmax for k in range(n)]


def draw_weights(pmf, nr_bins_per_dim: int, max_slices: int = 16):
    """The PMF plot as an [H, W, 3] uint8 image: tile k at grid cell
    (k // cols, k % cols), each bin a TILE_CELL_PX square."""
    rows, cols, _, tiles = weight_tiles(pmf, nr_bins_per_dim, max_slices)
    side = nr_bins_per_dim * TILE_CELL_PX
    pitch = side + TILE_GAP_PX
    img = np.full((rows * pitch + TILE_GAP_PX, cols * pitch + TILE_GAP_PX,
                   3), 255, np.uint8)
    for k, tile in enumerate(tiles):
        y0 = TILE_GAP_PX + (k // cols) * pitch
        x0 = TILE_GAP_PX + (k % cols) * pitch
        big = np.repeat(np.repeat(viridis(tile), TILE_CELL_PX, 0),
                        TILE_CELL_PX, 1)
        img[y0:y0 + side, x0:x0 + side] = big
    return img


def visualize_weights(pmf, nr_bins_per_dim: int, path='pmf.png',
                      max_slices: int = 16):
    """Orientation-PMF slice stack, one heat map per yaw slice, written
    as a PNG."""
    write_png(path, draw_weights(pmf, nr_bins_per_dim, max_slices))
    return path
