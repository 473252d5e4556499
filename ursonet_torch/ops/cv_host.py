"""numpy ports of the two OpenCV calls the host-parity augmentation makes
(`ursonet_tpu/ops/augment.py`: `_warp_host`, `_sim2real_op_host`), so
that the port needs no cv2:

  * `warp_perspective_inverse(img, M)` is
    `cv2.warpPerspective(img, M, (w, h), flags=cv2.WARP_INVERSE_MAP)`:
    nearest-neighbour sampling, `BORDER_CONSTANT` 0, the output at the
    input's size;
  * `gaussian_blur(img, sigma)` is `cv2.GaussianBlur(img, (0, 0), sigma)`
    on a float32 image: the kernel `getGaussianKernel` makes, applied
    separably with `BORDER_REFLECT_101`.

Both round as the OpenCV build they are held against computes (the
tests compare them with cv2 5.0's output, pixel for pixel):

  * the warp's source coordinate of destination pixel (x, y) is
    X = fma(m0, x, m1·y + m2) / fma(m6, x, m7·y + m8) (and Y likewise)
    in float32 with M rounded to float32, rounded half to even; a
    source outside the image gives 0. (OpenCV 4's scalar path computes
    the same in double; on this image it differs from cv2 5.0 at
    near-ties, ~4e-6–6e-5 of the pixels.)
  * the blur's kernel has cvRound(8σ + 1) | 1 taps (a float image),
    k(x) = exp(−x²/(2σ²)) normalized in double, then stored as float32;
    the row pass of a 3- or 5-tap kernel computes
    k1·(x₋₁ + x₊₁), then fma(k0, x₀, ·), then fma(k2, x₋₂ + x₊₂, ·); a
    longer one the taps left to right, each an fma; the column pass the
    centre tap, then fma(k_j, x₋ⱼ + x₊ⱼ, ·) outwards.

An fma of float32 operands is computed in float64 (the product is exact
there) and rounded once to float32; the sum's rounding to float64 first
can differ from a true fma only where that sum falls on a float32 tie.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _fma32(a, b, c) -> np.ndarray:
    """float32 fma(a, b, c) of float32 operands (see the module's note)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def warp_perspective_inverse(img: np.ndarray, M) -> np.ndarray:
    """`img` [H,W] or [H,W,C] warped by the homography `M` [3,3] in
    inverse-map mode: out(x, y) = img(round(X), round(Y)) for (X, Y, ·)
    = M·(x, y, 1) after the divide, 0 where that falls outside."""
    h, w = img.shape[:2]
    m = np.asarray(M, np.float64).astype(_F32).ravel()
    xs = np.arange(w, dtype=_F32)[None, :]
    ys = np.arange(h, dtype=_F32)[:, None]
    with np.errstate(divide='ignore', invalid='ignore'):
        den = _fma32(m[6], xs, m[7] * ys + m[8])
        sx = np.rint(_fma32(m[0], xs, m[1] * ys + m[2]) / den)
        sy = np.rint(_fma32(m[3], xs, m[4] * ys + m[5]) / den)
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    idx = (np.where(valid, sy, 0).astype(np.int64) * w
           + np.where(valid, sx, 0).astype(np.int64))
    flat = img.reshape(h * w, -1)
    out = flat[idx.ravel()]
    out[~valid.ravel()] = 0
    return out.reshape(img.shape)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """The float32 taps `cv2.getGaussianKernel(n, sigma, CV_32F)` gives
    for the size `GaussianBlur` picks on a float image, n = cvRound(8σ +
    1) | 1: exp(x²·(−0.125/σ²)) at x = 1−n, 3−n, ... (twice the offset),
    the sum 2·Σ(one side) + 1, each tap divided by it in double."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    scale = -0.125 / (sigma * sigma)
    side = [float(np.exp(float(x * x) * scale)) for x in range(1 - n, 0, 2)]
    total = 0.0
    for v in side:
        total += v
    total = total * 2 + 1.0
    half = [v / total for v in side] + [1.0 / total]
    return np.array(half + half[-2::-1], np.float64).astype(_F32)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source indices of positions −r .. n+r−1 under BORDER_REFLECT_101."""
    idx = np.abs(np.arange(-r, n + r))
    return np.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _row_pass(xp: np.ndarray, k: np.ndarray, w: int) -> np.ndarray:
    n = len(k)
    r = n // 2

    def tap(j):
        return xp[:, j:j + w]

    if n <= 5:
        s = (k[r + 1] * (tap(r - 1) + tap(r + 1))).astype(_F32)
        s = _fma32(k[r], tap(r), s)
        if n == 5:
            s = _fma32(k[r + 2], (tap(0) + tap(4)).astype(_F32), s)
        return s
    s = (k[0] * tap(0)).astype(_F32)
    for j in range(1, n):
        s = _fma32(k[j], tap(j), s)
    return s


def _column_pass(yp: np.ndarray, k: np.ndarray, h: int) -> np.ndarray:
    r = len(k) // 2
    s = (k[r] * yp[r:r + h]).astype(_F32)
    for j in range(1, r + 1):
        pair = (yp[r - j:r - j + h] + yp[r + j:r + j + h]).astype(_F32)
        s = _fma32(k[r + j], pair, s)
    return s


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (0, 0), sigma)` of a float32 [H,W] or
    [H,W,C] image, sigma > 0 (a one-tap kernel returns a copy)."""
    img = np.asarray(img, _F32)
    k = gaussian_kernel(sigma)
    if len(k) == 1:
        return img.copy()
    r = len(k) // 2
    h, w = img.shape[:2]
    row = _row_pass(img[:, _reflect101(w, r)], k, w)
    return _column_pass(row[_reflect101(h, r)], k, h)
