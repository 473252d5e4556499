"""Pose overlays, the port of `ursonet_tpu/ops/viz.py`'s
`project_points`, `axes_endpoints` and `save_axes_overlay`, drawn by the
port's own rasterizer (`data/synthetic.draw_segment`) and written by its
PNG encoder: the card's machine has no matplotlib.

The overlay is the frame at its own size with the ground-truth body axes
solid and the estimate's dashed (x red, y green, z blue, 2 px), and
circles of radius 8 px around the projected ground-truth (lime) and
estimated (yellow) locations. It follows the JAX package's figure, not
matplotlib's pixels.
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


def _line(img, p0, p1, color, dashed: bool) -> None:
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
        draw_segment(img, p0, p1, color, LINE_PX)
        return
    on, off = DASH_PX
    u = (p1 - p0) / n
    s = 0.0
    while s < n:
        draw_segment(img, p0 + u * s, p0 + u * min(s + on, n), color, LINE_PX)
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
            _line(img, o2, e2[i], c, dashed)

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
