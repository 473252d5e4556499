"""Synthetic URSO-layout datasets, the counterpart of
`ursonet_tpu/data/synthetic.py::make_urso_dataset`.

Renders a wireframe "spacecraft" (a cube with an antenna and a nose) at
random poses and writes

    {dir}/{subset}_images.csv, {subset}_poses_gt.csv, {i}_rgb.png

with the JAX package's random draws, file names, CSV headers and label
convention, so both packages' adapters read the same labels from a dir
either wrote. The body is drawn by a numpy rasterizer (thick segments as
capsules, a filled disc) with the JAX package's vertices, colours and
thicknesses; its pixels need not match cv2's. Frames are written by the
port's PNG encoder. The SPEED generator waits for a JPEG encoder.
"""

from __future__ import annotations

import os

import numpy as np

from ursonet_torch import se3
from ursonet_torch.data.png import write_png

_CUBE = np.array([
    [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
], dtype=np.float64)
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_segment(img, p0, p1, color, thickness: int) -> None:
    """Paint every pixel whose centre lies within thickness/2 of the
    segment p0-p1 ((x, y) pixel coordinates), clipped to the image."""
    h, w = img.shape[:2]
    r = thickness / 2.0
    (x0, y0), (x1, y1) = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    xa = max(int(np.floor(min(x0, x1) - r)), 0)
    xb = min(int(np.ceil(max(x0, x1) + r)), w - 1)
    ya = max(int(np.floor(min(y0, y1) - r)), 0)
    yb = min(int(np.ceil(max(y0, y1) + r)), h - 1)
    if xa > xb or ya > yb:
        return
    ys, xs = np.mgrid[ya:yb + 1, xa:xb + 1].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    n2 = dx * dx + dy * dy
    t = np.zeros_like(xs) if n2 == 0 else np.clip(
        ((xs - x0) * dx + (ys - y0) * dy) / n2, 0.0, 1.0)
    d2 = (xs - (x0 + t * dx)) ** 2 + (ys - (y0 + t * dy)) ** 2
    img[ya:yb + 1, xa:xb + 1][d2 <= r * r] = color


def draw_disc(img, centre, radius: float, color) -> None:
    draw_segment(img, centre, centre, color, 2 * radius)


def _render_pose(q, loc_cam, width, height, K):
    """The body at camera-frame location `loc_cam` (x right, y down, z
    forward) with orientation q: [H, W, 3] uint8."""
    img = np.zeros((height, width, 3), np.uint8)
    # mild background gradient for non-trivial statistics
    img[..., 0] = np.linspace(10, 40, width, dtype=np.uint8)[None, :]
    img[..., 2] = np.linspace(30, 5, height, dtype=np.uint8)[:, None]
    R = se3.quat2SO3(q)
    # cube + antenna along +z and a nose point along +y, a colour per
    # edge: the orientation is identifiable from one view
    body = np.concatenate([_CUBE * 1.5, [[0, 0, 3.0], [0, 2.4, 0]]], axis=0)
    uv = project(body @ np.asarray(R).T + loc_cam, K)
    rngc = np.random.RandomState(7)
    colors = [tuple(int(v) for v in rngc.randint(90, 255, 3))
              for _ in range(len(_EDGES) + 2)]
    for k, (a, b) in enumerate(_EDGES):
        draw_segment(img, uv[a], uv[b], colors[k], 2)
    draw_segment(img, uv[6], uv[8], (255, 255, 255), 3)
    draw_segment(img, uv[2], uv[9], (255, 60, 60), 3)
    draw_disc(img, uv[8], 5, (80, 255, 80))
    return img


def project(pts, K) -> np.ndarray:
    """Camera-frame points [N, 3] -> integer pixel coordinates [N, 2]
    (x, y), truncated as the JAX package truncates them."""
    p = pts[:, :2] / pts[:, 2:3]
    return ((K[:2, :2] @ p.T).T + K[:2, 2]).astype(int)


def _random_poses(rng, n, depth_range=(12.0, 30.0)):
    qs = rng.randn(n, 4)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs *= np.where(qs[:, 3:4] < 0, -1.0, 1.0)
    # camera-frame positions: near the optical axis, in front of the camera
    x = rng.uniform(-3, 3, n)
    y = rng.uniform(-2, 2, n)
    z = rng.uniform(*depth_range, n)
    return qs, np.stack([x, y, z], axis=1)


def render_intrinsics(width, height) -> np.ndarray:
    """The render camera: 90° horizontal, 73.7° vertical field of view."""
    fx = width / 2.0
    fy = height / (2 * np.tan(np.deg2rad(73.7) / 2))
    return np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1.0]])


def make_urso_dataset(dataset_dir, subsets=('train', 'val', 'test'),
                      n_per_subset=12, width=320, height=240, seed=0):
    """Create a synthetic URSO-layout dataset. n_per_subset: an int, or a
    dict by subset. Labels use the URSO/Unreal frame: (x, y, z) =
    (depth, right, down), i.e. camera-frame (cx, cy, cz) is stored as
    (cz, cx, cy)."""
    os.makedirs(dataset_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    K = render_intrinsics(width, height)
    idx = 0
    for subset in subsets:
        n = n_per_subset if isinstance(n_per_subset, int) \
            else n_per_subset[subset]
        qs, locs_cam = _random_poses(rng, n)
        names, rows = [], []
        for i in range(n):
            name = f"{idx}_rgb.png"
            write_png(os.path.join(dataset_dir, name),
                      _render_pose(qs[i], locs_cam[i], width, height, K))
            names.append(name)
            cx, cy, cz = locs_cam[i]
            rows.append([cz, cx, cy, *qs[i]])   # Unreal frame: x = depth
            idx += 1
        with open(os.path.join(dataset_dir, f"{subset}_images.csv"),
                  'w') as f:
            f.write("\n".join(names) + "\n")
        with open(os.path.join(dataset_dir, f"{subset}_poses_gt.csv"),
                  'w') as f:
            f.write("x,y,z,q1,q2,q3,q4\n")
            for row in rows:
                f.write(",".join(repr(float(v)) for v in row) + "\n")
    return dataset_dir
