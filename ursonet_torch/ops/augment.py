"""Batched on-device augmentation, the counterpart of the device half of
`ursonet_tpu/ops/augment.py`: the rotation augmentation and sim2real.

A random camera rotation R becomes the homography M = K·R·K⁻¹ at network
resolution (K already scaled to it, `scaled_intrinsics`), applied with
cv2 WARP_INVERSE_MAP semantics by the CUDA warp kernel
(`ops/warp_cuda.py`); the pose follows as t' = t·Rᵀ, q' = q_R ⊗ q.

Sim2real (the reference's imgaug pipeline, net.py:390-406) converts the
batch to gray, then, for a random half of the images, applies additive
Gaussian noise, a Gaussian blur, a brightness offset, a contrast gain and
coarse dropout in a random order, clips to [0, 255] and broadcasts the
gray channel back to three. It is plain PyTorch, as the JAX package
computes it in XLA and not in Pallas.

Each augmentation is split in two so that the randomness is explicit:
`draw_rotation` / `draw_sim2real` take a `torch.Generator` and return
the draws, `rotation_augment_apply` / `sim2real_apply` are deterministic
given them. `rotation_update` gives the rotation's homographies, its
identity flags and the pose update without touching the images: the
device preprocess hands the first two to the fused kernel
(`warp_cuda.warp_mold`: warp, identity select and mold in one launch),
whose plain version is `warp_mold_torch`.

The host-parity versions (`rotate_cam`, `rotate_image`, `sim2real_host`:
the JAX package's host functions, the reference's per-image augmentation)
run on one uint8 frame at its own resolution with numpy draws from a
`np.random.RandomState`, in the JAX package's order, and the port's own
numpy versions of cv2's warpPerspective and GaussianBlur
(`ops/cv_host.py`).

`warp_nearest_torch` / `warp_bilinear_torch` are the plain tensor-indexing
versions of the kernel (counterparts of `warp_nearest_jax` /
`warp_bilinear_jax`): the CPU path and the yardstick the kernel is held
against. Images are [B,C,H,W] here, where the JAX package used [B,H,W,C].
"""

from __future__ import annotations

import numpy as np
import torch

from ursonet_torch import se3, se3t
from ursonet_torch.ops import cv_host
from ursonet_torch.ops.warp_cuda import warp_cuda, warp_cuda_gray


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


def rotation_update(locs, quats, K, draws, rot_aug=True,
                    rot_image_aug=False):
    """The drawn rotations without the images: locs [B,3] camera-frame,
    quats [B,4], K [3,3] intrinsics at the images' resolution. Samples
    whose dice selects a disabled mode keep their pose. Returns (M [B,3,3]
    dst←src homographies, identity [B] bool: the samples left as they are,
    locs', quats')."""
    dev = locs.device
    b = locs.shape[0]
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
    identity = ~(use_cam | use_roll)

    locs_out = torch.einsum('bi,bji->bj', locs, R)     # t·Rᵀ rows
    quats_out = se3t.quat_mult(se3t.SO32quat(R), quats)
    locs_out = torch.where(identity[:, None], locs, locs_out)
    quats_out = torch.where(identity[:, None], quats, quats_out)
    return M, identity, locs_out, quats_out


def rotation_augment_apply(images, locs, quats, K, draws, rot_aug=True,
                           rot_image_aug=False, interpolation='nearest',
                           grayscale=False):
    """Apply the drawn rotations: images [B,C,H,W] f32, the rest as
    `rotation_update`. `grayscale`: the channels are equal (after
    sim2real), so only channel 0 is warped (`warp_cuda_gray`) and
    broadcast. Returns (images', locs', quats'). The preprocess runs the
    warp, the select and its mold as one `warp_mold` instead."""
    M, identity, locs_out, quats_out = rotation_update(
        locs, quats, K, draws, rot_aug, rot_image_aug)
    warp = warp_cuda_gray if grayscale else warp_cuda
    warped = warp(images, M, interpolation)
    images_out = torch.where(identity[:, None, None, None], images, warped)
    return images_out, locs_out, quats_out


def warp_mold_torch(src, Ms, identity, mean, interpolation='nearest'):
    """The plain version of the fused preprocess kernel
    (`warp_cuda.warp_mold`), the chain it replaces written out: the cast
    to f32 NCHW, the warp, the identity select, the mold. src: u8
    [B,H,W,3] (RGB) or a f32 gray plane [B,1,H,W] (every channel samples
    it); Ms [B,3,3] f32; identity [B] bool; mean: 3 values, taken as f32.
    Returns f32 [B,3,H,W]."""
    if interpolation not in ('nearest', 'bilinear'):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    warp = warp_nearest_torch if interpolation == 'nearest' \
        else warp_bilinear_torch
    if src.dtype == torch.uint8:
        images = src.permute(0, 3, 1, 2).contiguous().to(torch.float32)
        warped = warp(images, Ms)
    else:
        images = src.expand(src.shape[0], 3, *src.shape[2:])
        warped = warp(src, Ms).expand(images.shape)
    images = torch.where(identity.to(images.device)[:, None, None, None],
                         images, warped)
    mean = torch.as_tensor(np.asarray(mean, np.float32),
                           device=images.device).view(1, 3, 1, 1)
    return images - mean


# --------------------------------------------------------------------------
# sim2real
#
# The ops run batched on one gray channel [B,1,H,W]: every imgaug op of the
# reference's sequential is per_channel=False after the grayscale step.
# Each op's magnitudes are drawn once per image and op, whatever its
# position in the order (the JAX package draws op j's from op_keys[j] in
# the per-image mode and op perm[i]'s from op_keys[i] in the shared one;
# either way one draw per op).

SIM2REAL_OPS = ('noise', 'blur', 'add', 'mul', 'dropout')


def draw_sim2real(generator: torch.Generator, b: int, h: int, w: int,
                  per_image_order: bool = False) -> dict:
    """The random draws of one sim2real batch, on the generator's device:
    'apply' [B] bool (the pipeline runs on about half the images), 'order'
    [5] (one op order for the batch) or [B,5] (one per image), indices
    into SIM2REAL_OPS, and per image: 'noise' [B,1,H,W] standard normals,
    'sigma' [B] in [0, 1.5) (blur), 'add' [B] in [-20, 20), 'mul' [B] in
    [0.5, 2), and the dropout's 'p' [B] (0 or 0.03), cell size fraction
    'size' [B] in [0.02, 0.1) and hash 'salt' [B] in [0, 2^30)."""
    dev = generator.device

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    if per_image_order:
        order = torch.argsort(rand(b, 5), dim=1)
    else:
        order = torch.randperm(5, generator=generator, device=dev)
    return {
        'apply': rand(b) < 0.5,
        'order': order,
        'noise': torch.randn(b, 1, h, w, generator=generator, device=dev),
        'sigma': rand(b) * 1.5,
        'add': rand(b) * 40.0 - 20.0,
        'mul': rand(b) * 1.5 + 0.5,
        'p': torch.where(rand(b) < 0.5, 0.03, 0.0),
        'size': rand(b) * 0.08 + 0.02,
        'salt': torch.randint(0, 2 ** 30, (b,), generator=generator,
                              device=dev),
    }


def _per_image(v):
    return v.reshape(-1, 1, 1, 1)


def _op_noise(x, d):
    # AdditiveGaussianNoise(scale=0.01*255)
    return x + d['noise'] * (0.01 * 255.0)


def _op_blur(x, d):
    # GaussianBlur(sigma in [0, 1.5)), depthwise separable over 9 zero-
    # padded taps summed left to right, as the JAX package sums them
    h, w = x.shape[2:]
    sigma = _per_image(d['sigma'].to(torch.float32))
    taps = torch.arange(-4, 5, dtype=torch.float32, device=x.device)
    s = torch.clamp(sigma, min=1e-3)
    k = torch.exp(-0.5 * (taps / s) ** 2)              # [B,1,1,9]
    k = k / torch.sum(k, dim=-1, keepdim=True)
    p = torch.nn.functional.pad(x, (0, 0, 4, 4))
    out = p[:, :, 0:h] * k[..., 0:1]
    for i in range(1, 9):
        out = out + p[:, :, i:i + h] * k[..., i:i + 1]
    p = torch.nn.functional.pad(out, (4, 4, 0, 0))
    out = p[..., 0:w] * k[..., 0:1]
    for i in range(1, 9):
        out = out + p[..., i:i + w] * k[..., i:i + 1]
    return torch.where(sigma < 1e-3, x, out)


def _op_add(x, d):
    return x + _per_image(d['add'].to(torch.float32))


def _op_mul(x, d):
    return x * _per_image(d['mul'].to(torch.float32))


_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2^32 for int64 tensors a in [0, 2^32) and a constant
    c < 2^32, by 16-bit halves of a (the full product overflows int64)."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash_uniform(*ints):
    """The JAX package's stateless per-element uniform in [0, 1): an
    xorshift-multiply mix of int32 inputs in uint32 arithmetic (int64
    tensors here), converted to f32 with rounding to nearest."""
    h = torch.full((), 0x9E3779B9, dtype=torch.int64, device=ints[0].device)
    for v in ints:
        h = h ^ _mul32(v.to(torch.int64) & _M32, 0x85EBCA6B)
        h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
        h = h ^ (h >> 16)
    return h.to(torch.float32) / 4294967296.0


def _op_dropout(x, d):
    # CoarseDropout(p in {0, 0.03}, size_percent in [0.02, 0.1)): a
    # per-cell uniform from a hash of the cell coordinates
    h, w = x.shape[2:]
    block = 1.0 / _per_image(d['size'].to(torch.float32))
    iy = torch.arange(h, dtype=torch.float32, device=x.device).view(1, 1, h, 1)
    ix = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, 1, w)
    cy = torch.floor(iy / block).to(torch.int32)
    cx = torch.floor(ix / block).to(torch.int32)
    salt = _per_image(d['salt'].to(torch.int32))
    cell = hash_uniform(cy * 65537 + cx, salt + 0 * cy)
    p = _per_image(d['p'].to(torch.float32))
    return torch.where(cell < p, torch.zeros((), device=x.device), x)


_OPS = (_op_noise, _op_blur, _op_add, _op_mul, _op_dropout)


def sim2real_apply(images, draws):
    """Apply the drawn sim2real pipeline: images [B,3,H,W] f32 in [0,255]
    -> [B,3,H,W] with three equal channels (a broadcast view of one).
    A [5] order runs op order[i] at step i on the whole batch; a [B,5]
    order runs, at step t, every op on the batch and keeps for image i
    the output of op order[i, t], as the JAX package does."""
    if draws['noise'].shape[2:] != images.shape[2:]:
        raise ValueError(f"sim2real draws for {tuple(draws['noise'].shape)} "
                         f"images, given {tuple(images.shape)}")
    gray = (0.2126 * images[:, 0:1] + 0.7152 * images[:, 1:2]
            + 0.0722 * images[:, 2:3])
    order = draws['order'].to(images.device)
    x = gray
    if order.dim() == 1:
        for i in order.tolist():
            x = _OPS[i](x, draws)
    else:
        for t in range(order.shape[1]):
            outs = torch.stack([op(x, draws) for op in _OPS])   # [5,B,1,H,W]
            pick = order[:, t].view(1, -1, 1, 1, 1).expand(1, *x.shape)
            x = torch.gather(outs, 0, pick)[0]
    x = torch.clamp(x, 0.0, 255.0)
    out = torch.where(_per_image(draws['apply'].to(images.device)), x, gray)
    return out.expand(images.shape)


def scaled_intrinsics(K_original, window, scale) -> np.ndarray:
    """Intrinsics at network resolution: K' = S·K with the resize scale and
    the pad window offset, so the warp M = K'RK'⁻¹ at network resolution
    matches the warp at the original resolution up to resampling."""
    K = np.asarray(K_original, np.float64).copy()
    y1, x1, _, _ = window
    S = np.array([[scale, 0, x1], [0, scale, y1], [0, 0, 1.0]])
    return S @ K


# --------------------------------------------------------------------------
# host parity: one frame at its own resolution, numpy draws


def rotate_cam(image, t, q, K, magnitude, rng):
    """Random camera rotation of one frame: pitch, yaw and roll each
    (rand − 0.5)·magnitude degrees (`rng.rand(3)`), as the homography
    warp and the pose update of `_warp_host`."""
    pyr_change = (rng.rand(3) - 0.5) * magnitude
    return _warp_host(image, t, q, K, pyr_change)


def rotate_image(image, t, q, K, rng):
    """Random in-plane roll of one frame, (rand − 0.5)·170 degrees
    (`rng.rand(1)`)."""
    change = (rng.rand(1) - 0.5) * 170
    return _warp_host(image, t, q, K, np.array([0.0, 0.0, change[0]]))


def _warp_host(image, t, q, K, pyr_change):
    """Warp `image` by M = K·R·K⁻¹ (inverse map, nearest, zero border:
    `cv_host.warp_perspective_inverse`) and rotate the pose: t' = t·Rᵀ,
    q' = q_R ⊗ q. Returns (image', t', q') in float64."""
    R_change = se3.euler2SO3_left(pyr_change[0], pyr_change[1],
                                  pyr_change[2])
    K = np.asarray(K, np.float64)
    M = K @ R_change @ np.linalg.inv(K)
    warped = cv_host.warp_perspective_inverse(image, M)
    t_new = np.asarray(t, np.float64) @ R_change.T
    q_new = se3.quat_mult(se3.SO32quat(R_change), q)
    return warped, t_new, q_new


def sim2real_host(image, rng):
    """The reference's sim2real on one uint8 frame [H,W,3]: Rec.709 gray
    in float32 on three channels; with probability 1/2 (`rng.rand(1)`)
    the five ops in the order `rng.permutation(5)`, each drawing its own
    magnitudes; clipped to [0, 255] and truncated to uint8."""
    img = image.astype(np.float32)
    gray = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    img = np.repeat(gray[..., None], 3, axis=2)
    if rng.rand(1)[0] > 0.5:
        order = rng.permutation(5)
        for k in order:
            img = _sim2real_op_host(SIM2REAL_OPS[k], img, rng)
    return np.clip(img, 0, 255).astype(image.dtype)


def _sim2real_op_host(name, img, rng):
    """One sim2real op on a float32 [H,W,3] frame, its draws from `rng`."""
    if name == 'noise':
        return img + rng.randn(*img.shape[:2], 1).astype(np.float32) \
            * (0.01 * 255)
    if name == 'blur':
        sigma = rng.rand(1)[0] * 1.5
        if sigma < 1e-3:
            return img
        return cv_host.gaussian_blur(img, sigma)
    if name == 'add':
        return img + rng.uniform(-20, 20)
    if name == 'mul':
        return img * rng.uniform(0.5, 2.0)
    if name == 'dropout':
        p = float(rng.choice([0.0, 0.03]))
        if p == 0.0:
            return img
        sp = rng.uniform(0.02, 0.1)
        h, w = img.shape[:2]
        mh, mw = max(1, int(h * sp)), max(1, int(w * sp))
        mask = (rng.rand(mh, mw) < p)
        mask = np.repeat(np.repeat(mask, -(-h // mh), 0), -(-w // mw),
                         1)[:h, :w]
        out = img.copy()
        out[mask] = 0
        return out
    raise ValueError(name)
