"""Inputs made from the run's seed, on the card in a few large calls."""

from __future__ import annotations

import numpy as np
import torch


def derived_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of draws of a run (weights, images,
    poses, ...), from the run's seed."""
    return int(np.random.SeedSequence([int(seed), int(stream)])
               .generate_state(1, np.uint64)[0])


def image_pool(seed: int, n: int, batch: int, h: int, w: int,
               device) -> list:
    """n batches of `batch` uint8 images [B,H,W,3] in host memory (numpy),
    drawn uniformly on `device`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(derived_seed(seed, 1))
    return [torch.randint(0, 256, (batch, h, w, 3), generator=gen,
                          dtype=torch.uint8, device=dev).cpu().numpy()
            for _ in range(n)]


def pad64_geometry(h0: int, w0: int, min_dim: int, max_dim: int):
    """(network h, w, window (y1, x1, y2, x2), scale) of a h0 x w0 frame
    resized as UrsoNet's pad64 mode does: the scale that brings the short
    side to min_dim unless the long side would pass max_dim (never up
    below 1), the frame centred in a multiple of 64."""
    scale = max(1.0, min_dim / min(h0, w0))
    if round(max(h0, w0) * scale) > max_dim:
        scale = max_dim / max(h0, w0)
    h, w = round(h0 * scale), round(w0 * scale)
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    y1, x1 = (hp - h) // 2, (wp - w) // 2
    return hp, wp, (y1, x1, y1 + h, x1 + w), scale


def urso_frames(seed: int, n: int, frame_hw, net_hw, window, scale,
                device) -> dict:
    """A resident dataset of n URSO-like frames at the network shape, as
    the program's loader holds it: 'images_u8' [n,H,W,3] (uniform pixels
    inside the window, zero in the padding), 'image_meta' [n,12],
    'location' [n,3] (z in 5..40 m, x and y within ±0.3 z), 'quaternion'
    [n,4] (uniform unit quaternions, scalar last, w >= 0)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(derived_seed(seed, 2))
    h, w = net_hw
    y1, x1, y2, x2 = window
    images = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=dev)
    for lo in range(0, n, 1024):
        hi = min(n, lo + 1024)
        images[lo:hi, y1:y2, x1:x2] = torch.randint(
            0, 256, (hi - lo, y2 - y1, x2 - x1, 3), generator=gen,
            dtype=torch.uint8, device=dev)
    z = 5.0 + 35.0 * torch.rand(n, 1, generator=gen, device=dev)
    xy = (torch.rand(n, 2, generator=gen, device=dev) - 0.5) * 0.6 * z
    q = torch.randn(n, 4, generator=gen, device=dev)
    q = q / q.norm(dim=1, keepdim=True)
    q = torch.where(q[:, 3:] < 0, -q, q)
    meta = torch.tensor([0.0, frame_hw[0], frame_hw[1], 3, h, w, 3,
                         y1, x1, y2, x2, scale], device=dev).repeat(n, 1)
    meta[:, 0] = torch.arange(n, device=dev, dtype=torch.float32)
    return {'images_u8': images, 'image_meta': meta,
            'location': torch.cat([xy, z], 1), 'quaternion': q}
