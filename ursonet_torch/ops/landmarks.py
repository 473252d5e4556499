"""Landmark heatmaps of the landmark model (BACKBONE 'hrnet_w32'): the
landmarks' pixels from a pose, HRNet's Gaussian targets and visibility
weights, and the decode of heatmaps back to pixels. Plain PyTorch on the
batch's device.

`project` puts body-frame landmarks [K,3] (metres) through the pose
(location [B,3], scalar-last quaternion [B,4]: the label-frame point is
R(q)·p + t, the convention of the keypoint targets in `data/loader.py`)
and the intrinsics K at the network's resolution: pixels [B,K,2] (x, y)
and depths [B,K]. The label frame is the optical one (x right, y down,
z forward: SPEED's) or URSO's Unreal frame (x forward, y right, z down),
permuted to the optical one first, as `ops/viz.py::project_points`
draws URSO poses.

`render` is HRNet's `JointsDataset.generate_target` (target type
'gaussian') on the card: for a landmark at pixel (x, y) the heatmap
centre is (int(x/s + 0.5), int(y/s + 0.5)) at stride s (Python's int,
which truncates toward zero), and the target is
exp(−((u − μx)² + (v − μy)²) / (2σ²)) inside the (6σ + 1)² window around
it (|u − μx| ≤ 3σ, |v − μy| ≤ 3σ, σ's window half-width as HRNet's
`int(3σ)`), zero elsewhere. A landmark whose window lies wholly outside
the heatmap (its upper-left corner at or past the far edge, its
lower-right one before 0), or which lies behind the camera, gets weight
0 and an all-zero target; every other landmark weight 1.

`decode` is HRNet's `get_max_preds` and the quarter-pixel refinement of
`get_final_preds` (TEST.POST_PROCESS): the argmax of each heatmap, (0, 0)
where its maximum is not positive, then, where 1 < x < w − 1 and
1 < y < h − 1, a quarter pixel toward the larger neighbour along each
axis (sign of the difference), scaled by the stride back to input
pixels.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ursonet_torch import se3t

# heatmaps at a quarter of the input's resolution
HEATMAP_STRIDE = 4
# the backbones that regress landmark heatmaps (`models/hrnet.py`)
HEATMAP_BACKBONES = ('hrnet_w32',)

# The landmark model's counter, on the host with no synchronisation: the
# modules run and the fusion sums they made (`models/hrnet.py`), the
# landmarks rendered into heatmaps and, as a 0-d tensor on the device
# read only when asked, those dropped as out of view (`data/loader.py`).
counts = {'modules': 0, 'fusion_sums': 0, 'rendered': 0, 'dropped': 0}
_lock = threading.Lock()


def reset_counts() -> None:
    with _lock:
        for k in counts:
            counts[k] = 0


def count(**add) -> None:
    """Add to `counts` (a tensor value stays on its device)."""
    with _lock:
        for k, v in add.items():
            counts[k] = counts[k] + v


def is_heatmap_model(backbone: str) -> bool:
    return backbone in HEATMAP_BACKBONES


def default_landmarks(k: int) -> np.ndarray:
    """[k,3] body-frame landmarks (metres) for a configuration that gives
    none (LANDMARKS None): the 8 corners of a 1 m cube centred on the
    body's origin, then points 0.8 m out along +x, +y, +z in turn (for
    k = 11, a box with three antenna tips, the layout of the SPEED
    satellite's landmarks)."""
    corners = [(x, y, z) for x in (-.5, .5) for y in (-.5, .5)
               for z in (-.5, .5)]
    tips = [tuple(0.8 * float(i == a) for i in range(3)) for a in range(3)]
    pts = (corners + [tips[i % 3] for i in range(max(k - 8, 0))])[:k]
    return np.asarray(pts, np.float32)


def landmarks_of(config) -> np.ndarray:
    """The configuration's landmarks [NUM_LANDMARKS, 3]: LANDMARKS, or
    `default_landmarks` where it is None."""
    k = int(config.NUM_LANDMARKS)
    pts = getattr(config, 'LANDMARKS', None)
    pts = default_landmarks(k) if pts is None else np.asarray(pts,
                                                              np.float32)
    if pts.shape != (k, 3):
        raise ValueError(f"LANDMARKS holds {pts.shape}, NUM_LANDMARKS "
                         f"asks for ({k}, 3)")
    return pts


def project(points, locs, quats, k_mat, frame: str = 'camera'):
    """(pixels [B,K,2], depths [B,K]) of body-frame `points` [K,3] under
    the poses (`locs` [B,3], `quats` [B,4]) in the label `frame`
    ('camera' or 'unreal') and intrinsics `k_mat` [3,3], all f32 on one
    device."""
    r = se3t.quat2SO3(quats)                                  # [B,3,3]
    cam = torch.einsum('bij,kj->bki', r, points) + locs[:, None, :]
    if frame == 'unreal':
        cam = cam[..., [1, 2, 0]]
    uvw = torch.einsum('ij,bkj->bki', k_mat, cam)
    z = uvw[..., 2]
    return uvw[..., :2] / z[..., None], cam[..., 2]


def render(pixels, depths, heatmap_hw, stride: int, sigma: float):
    """(targets [B,K,h,w] f32, weights [B,K] f32) of landmark pixels
    [B,K,2] with their depths [B,K] (module docstring)."""
    h, w = heatmap_hw
    dev = pixels.device
    radius = int(sigma * 3)
    mu = torch.trunc(pixels / stride + 0.5)                   # [B,K,2]
    ul, br = mu - radius, mu + radius + 1
    size = torch.tensor([w, h], dtype=mu.dtype, device=dev)
    seen = (ul < size).all(-1) & (br >= 0).all(-1) & (depths > 0)
    weights = seen.to(torch.float32)
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    du = u - mu[..., 0:1]                                     # [B,K,w]
    dv = v - mu[..., 1:2]                                     # [B,K,h]
    du = torch.where(du.abs() <= radius, du, torch.inf)
    dv = torch.where(dv.abs() <= radius, dv, torch.inf)
    d2 = dv[..., :, None] ** 2 + du[..., None, :] ** 2
    targets = torch.exp(-d2 / (2 * sigma ** 2)) * weights[..., None, None]
    return targets, weights


def decode(heatmaps, stride: int):
    """(pixels [B,K,2] f32 in input pixels, maxima [B,K]) of heatmaps
    [B,K,h,w] (module docstring)."""
    b, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, k, h * w).float()
    maxval, idx = flat.max(-1)
    x = (idx % w).to(torch.float32)
    y = torch.div(idx, w, rounding_mode='floor').to(torch.float32)
    found = (maxval > 0).to(torch.float32)
    x, y = x * found, y * found
    px, py = x.long(), y.long()
    inner = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    # neighbours' indices, clamped where `inner` leaves the shift out
    pxc, pyc = px.clamp(1, w - 2), py.clamp(1, h - 2)

    def at(yy, xx):
        return flat.gather(-1, (yy * w + xx)[..., None])[..., 0]

    dx = at(pyc, pxc + 1) - at(pyc, pxc - 1)
    dy = at(pyc + 1, pxc) - at(pyc - 1, pxc)
    x = x + torch.where(inner, torch.sign(dx) * 0.25, 0.0)
    y = y + torch.where(inner, torch.sign(dy) * 0.25, 0.0)
    return torch.stack([x, y], -1) * stride, maxval
