"""Image resize, pad and mold on the host, the counterpart of
`ursonet_tpu/ops/image.py`: `resize_image` and its geometry, the
mean-subtract mold and its inverse, and the image meta vector.

`resize_image` resamples bilinearly with cv2 INTER_LINEAR's half-pixel
mapping on float32 pixels (what the JAX package gets from cv2), then
zero-pads to the mode's shape and truncates back to the input dtype,
as the JAX package does. It computes with torch's threaded CPU ops
(a horizontal pass, then a vertical one), which take a quarter of
numpy's time on a 1280×960 frame. At an integer downscale such as the
URSO camera's 0.5 the result equals cv2's exactly; at other scales a
pixel may differ by one step where cv2's float rounding differs
(tests/test_torch_data.py measures the share). No image library is
needed.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def _pick_scale(h, w, min_dim, max_dim, min_scale, clamp_max):
    """Bring the small side up to `min_dim`, floor at `min_scale`, then cap
    so the long side does not exceed `max_dim` (the cap wins)."""
    scale = min_dim / min(h, w) if min_dim else 1
    if min_scale:
        scale = max(scale, min_scale)
    if clamp_max and max_dim and round(max(h, w) * scale) > max_dim:
        scale = max_dim / max(h, w)
    return scale


def _centered_window(h, w, out_h, out_w):
    top, left = (out_h - h) // 2, (out_w - w) // 2
    return (top, left, top + h, left + w)


def resize_geometry(h, w, min_dim=None, max_dim=None, min_scale=None,
                    mode="square"):
    """(out_shape, window, scale) that `resize_image` gives an h×w image.

    out_shape is (out_h, out_w); window = (y1, x1, y2, x2) frames the
    resized content inside the output. For 'crop' the window is the
    whole min_dim² crop (its offset is random and does not move the
    intrinsics of the crop's own pixel grid).
    """
    if mode == "none":
        return (h, w), (0, 0, h, w), 1
    scale = _pick_scale(h, w, min_dim, max_dim, min_scale,
                        clamp_max=(mode != "crop"))
    if scale != 1:
        h, w = round(h * scale), round(w * scale)
    if mode == "square":
        out = (max_dim, max_dim)
    elif mode == "pad64":
        if min_dim % 64:
            raise ValueError("pad64 requires min_dim % 64 == 0")
        out = (-(-h // 64) * 64, -(-w // 64) * 64)
    elif mode == "crop":
        return (min_dim, min_dim), (0, 0, min_dim, min_dim), scale
    else:
        raise ValueError(f"unknown resize mode: {mode!r}")
    return out, _centered_window(h, w, *out), scale


def _linear_coeffs(n_in: int, n_out: int):
    """cv2 INTER_LINEAR's source index pairs and float32 weights along
    one axis: src = (dst + 0.5)·(n_in / n_out) − 0.5, clamped at both
    ends."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    lo, hi = s < 0, s >= n_in - 1
    f[lo | hi] = 0
    s[lo] = 0
    s[hi] = n_in - 1
    s1 = np.minimum(s + 1, n_in - 1)
    w0 = (np.float32(1) - f).astype(np.float32)
    return (torch.from_numpy(s), torch.from_numpy(s1), torch.from_numpy(w0),
            torch.from_numpy(f))


def bilinear_resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W] or [H, W, C] -> float32 [out_h, out_w(, C)], bilinear with
    cv2 INTER_LINEAR's pixel mapping."""
    h, w = image.shape[:2]
    x0, x1, a0, a1 = _linear_coeffs(w, out_w)
    y0, y1, b0, b1 = _linear_coeffs(h, out_h)
    src = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float32)
    if src.ndim == 2:
        src = src[..., None]
    hz = (src.index_select(1, x0) * a0[None, :, None]
          + src.index_select(1, x1) * a1[None, :, None])
    out = (hz.index_select(0, y0) * b0[:, None, None]
           + hz.index_select(0, y1) * b1[:, None, None]).numpy()
    return out if image.ndim == 3 else out[..., 0]


def _pad_centered(image, out_h, out_w):
    """Zero-pad `image` to (out_h, out_w), split evenly per axis with the
    odd pixel going to the bottom/right. Returns (padded, window, padding)
    with window = (y1, x1, y2, x2) framing the original content."""
    h, w = image.shape[:2]
    window = _centered_window(h, w, out_h, out_w)
    top, left = window[:2]
    padding = [(top, out_h - h - top), (left, out_w - w - left)]
    if image.ndim > 2:
        padding.append((0, 0))
    padded = np.pad(image, padding, mode="constant", constant_values=0)
    return padded, window, padding


def resize_image(image, min_dim=None, max_dim=None, min_scale=None,
                 mode="square", rng: random.Random | None = None):
    """Resize keeping the aspect ratio, then pad or crop by `mode`
    (none | square | pad64 | crop; crop draws its offset from `rng`,
    default the `random` module). Returns (image, window, scale,
    padding, crop) with window = (y1, x1, y2, x2) framing the content,
    the image in the input's dtype (resampled values truncated); the
    shape, window and scale are `resize_geometry`'s."""
    image_dtype = image.dtype
    h, w = image.shape[:2]
    (out_h, out_w), window, scale = resize_geometry(h, w, min_dim, max_dim,
                                                    min_scale, mode)
    no_pad = [(0, 0), (0, 0), (0, 0)]
    if mode == "none":
        return image, window, scale, no_pad, None
    if scale != 1:
        image = bilinear_resize(image, round(h * scale), round(w * scale))
    if mode == "crop":
        h, w = image.shape[:2]
        r = rng if rng is not None else random
        y, x = r.randint(0, h - min_dim), r.randint(0, w - min_dim)
        image = image[y:y + min_dim, x:x + min_dim]
        return (image.astype(image_dtype), window, scale, no_pad,
                (y, x, min_dim, min_dim))
    image, _, padding = _pad_centered(image, out_h, out_w)
    return image.astype(image_dtype), window, scale, padding, None


def mold_image(image, config) -> np.ndarray:
    """Mean-subtract and cast: to float16 under F16, as the JAX package
    molds (the model then computes in bf16), else to f32."""
    dtype = np.float16 if getattr(config, 'F16', False) else np.float32
    mean = np.asarray(config.MEAN_PIXEL)
    if image.shape[-1] == 3:
        return image.astype(dtype) - mean.astype(dtype)
    return image.astype(dtype) - np.mean(mean).astype(dtype)


def unmold_image(normalized_images, config) -> np.ndarray:
    """Inverse of mold_image."""
    return (normalized_images + np.asarray(config.MEAN_PIXEL)).astype(np.uint8)


def compose_image_meta(image_id, original_image_shape, image_shape, window,
                       scale) -> np.ndarray:
    """id(1) + original shape(3) + shape(3) + window(4) + scale(1)."""
    return np.array(
        [image_id] + list(original_image_shape) + list(image_shape) +
        list(window) + [scale], dtype=np.float32)


def parse_image_meta(meta) -> dict:
    """Unpack compose_image_meta vectors (batched)."""
    meta = np.atleast_2d(meta)
    return {
        "image_id": meta[:, 0],
        "original_image_shape": meta[:, 1:4],
        "image_shape": meta[:, 4:7],
        "window": meta[:, 7:11],
        "scale": meta[:, 11],
    }
