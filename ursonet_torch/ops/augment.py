"""Batched on-device rotation augmentation, the counterpart of the device
half of `ursonet_tpu/ops/augment.py`.

A random camera rotation R becomes the homography M = K·R·K⁻¹ at network
resolution (K already scaled to it, `scaled_intrinsics`), applied with
cv2 WARP_INVERSE_MAP semantics by the CUDA warp kernel
(`ops/warp_cuda.py`); the pose follows as t' = t·Rᵀ, q' = q_R ⊗ q.

The augmentation is split in two so that the randomness is explicit:
`draw_rotation` takes a `torch.Generator` and returns the draws,
`rotation_augment_apply` is deterministic given them.

`warp_nearest_torch` / `warp_bilinear_torch` are the plain tensor-indexing
versions of the kernel (counterparts of `warp_nearest_jax` /
`warp_bilinear_jax`): the CPU path and the yardstick the kernel is held
against. Images are [B,C,H,W] here, where the JAX package used [B,H,W,C].
"""

from __future__ import annotations

import numpy as np
import torch

from ursonet_torch import se3t
from ursonet_torch.ops.warp_cuda import warp_cuda


def _warp_coords(Ms, h, w):
    """Source coordinates for dst(x,y) = src(M·(x,y,1)). Ms [B,3,3] ->
    (sx, sy), each [B,H,W] f32, with each product and sum rounded in the
    order the CUDA kernel uses."""
    xs = torch.arange(w, dtype=torch.float32, device=Ms.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=Ms.device).view(1, h, 1)

    def m(i, j):
        return Ms[:, i, j].reshape(-1, 1, 1)

    den = m(2, 0) * xs + m(2, 1) * ys + m(2, 2)
    sx = (m(0, 0) * xs + m(0, 1) * ys + m(0, 2)) / den
    sy = (m(1, 0) * xs + m(1, 1) * ys + m(1, 2)) / den
    return sx, sy


def _gather(images, yy, xx):
    """images [B,C,H,W] at integer-valued float coords yy, xx [B,H,W];
    taps outside the image give 0."""
    b, c, h, w = images.shape
    valid = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
    idx = (torch.where(valid, yy, 0).long() * w
           + torch.where(valid, xx, 0).long())
    v = torch.gather(images.reshape(b, c, h * w), 2,
                     idx.reshape(b, 1, h * w).expand(b, c, h * w))
    v = v.reshape(b, c, h, w)
    return torch.where(valid[:, None], v, torch.zeros((), dtype=v.dtype,
                                                      device=v.device))


def warp_nearest_torch(images, Ms):
    """Nearest warp (round half to even, validity after rounding).
    images [B,C,H,W] f32, Ms [B,3,3] f32."""
    h, w = images.shape[2:]
    sx, sy = _warp_coords(Ms, h, w)
    return _gather(images, torch.round(sy), torch.round(sx))


def warp_bilinear_torch(images, Ms):
    """Bilinear warp, taps outside the image 0. images [B,C,H,W] f32."""
    h, w = images.shape[2:]
    sx, sy = _warp_coords(Ms, h, w)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    return (_gather(images, y0, x0) * (1 - fx) * (1 - fy)
            + _gather(images, y0, x0 + 1) * fx * (1 - fy)
            + _gather(images, y0 + 1, x0) * (1 - fx) * fy
            + _gather(images, y0 + 1, x0 + 1) * fx * fy)


def draw_rotation(generator: torch.Generator, b: int,
                  magnitude: float = 20.0) -> dict:
    """The random draws of one augmentation, on the generator's device:
    per sample a dice in [0,1) (camera rotation above 0.5, roll at or
    below), camera Euler angles in ±magnitude/2 degrees per axis, and a
    roll in ±85 degrees."""
    dev = generator.device
    dice = torch.rand(b, generator=generator, device=dev)
    pyr_cam = (torch.rand(b, 3, generator=generator, device=dev) - 0.5) \
        * magnitude
    roll = (torch.rand(b, 1, generator=generator, device=dev) - 0.5) * 170.0
    return {"dice": dice, "pyr_cam": pyr_cam, "roll": roll}


def rotation_augment_apply(images, locs, quats, K, draws, rot_aug=True,
                           rot_image_aug=False, interpolation='nearest'):
    """Apply the drawn rotations: images [B,C,H,W] f32, locs [B,3]
    camera-frame, quats [B,4], K [3,3] intrinsics at the images'
    resolution. Samples whose dice selects a disabled mode pass through
    unchanged. Returns (images', locs', quats')."""
    dev = images.device
    b = images.shape[0]
    dice = draws["dice"].to(dev, torch.float32)
    pyr_cam = draws["pyr_cam"].to(dev, torch.float32)
    roll = draws["roll"].to(dev, torch.float32)
    zeros2 = torch.zeros((b, 2), dtype=torch.float32, device=dev)
    pyr_roll = torch.cat([zeros2, roll], dim=1)

    use_cam = (dice > 0.5) & bool(rot_aug)
    use_roll = (dice <= 0.5) & bool(rot_image_aug)
    pyr = torch.where(use_cam[:, None], pyr_cam,
                      torch.where(use_roll[:, None], pyr_roll,
                                  torch.zeros_like(pyr_cam)))

    R = se3t.euler2SO3_left(pyr[:, 0], pyr[:, 1], pyr[:, 2])  # [B,3,3]
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    M = (K @ R @ torch.linalg.inv_ex(K).inverse).contiguous()

    warped = warp_cuda(images, M, interpolation)
    identity = ~(use_cam | use_roll)
    images_out = torch.where(identity[:, None, None, None], images, warped)

    locs_out = torch.einsum('bi,bji->bj', locs, R)     # t·Rᵀ rows
    quats_out = se3t.quat_mult(se3t.SO32quat(R), quats)
    locs_out = torch.where(identity[:, None], locs, locs_out)
    quats_out = torch.where(identity[:, None], quats, quats_out)
    return images_out, locs_out, quats_out


def scaled_intrinsics(K_original, window, scale) -> np.ndarray:
    """Intrinsics at network resolution: K' = S·K with the resize scale and
    the pad window offset, so the warp M = K'RK'⁻¹ at network resolution
    matches the warp at the original resolution up to resampling."""
    K = np.asarray(K_original, np.float64).copy()
    y1, x1, _, _ = window
    S = np.array([[scale, 0, x1], [0, scale, y1], [0, 0, 1.0]])
    return S @ K
