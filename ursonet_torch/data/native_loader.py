"""The native batch loader, the port's counterpart of
`ursonet_tpu/data/native_loader.py` (ctypes over
`native/host_loader.cpp`): one call decodes a list of PNG or JPEG files
on a pool of host threads, resizes each to the content window and places
it in a zeroed uint8 batch.

    load_batch(paths, out_h, out_w, content_h, content_w, top, left,
               nthreads=0) -> [N, out_h, out_w, 3] uint8
    decode(path) -> [H, W, 3] uint8 at the file's own size

The library is `csrc/host_loader.cpp` (host C++17 on zlib: no libjpeg,
no libpng; JPEG through the port's codec, `csrc/jpeg_codec.h`), built
with g++ at first use into `.torch_ext/` (`ops/cuda_build.py`). A failed
build raises RuntimeError with the compiler's output: there is no quiet
fallback, and `data/loader.py` takes the Python path only when the
config asks for it (NATIVE_LOADER = False) or the geometry is one the
native route never serves. ctypes releases the GIL for each call.

The resize is the JAX native route's: sample centers at
(i + 0.5) * scale - 0.5, float32 arithmetic, the value truncated on the
store. The Python path (`ops/image.resize_image`) rounds as cv2 does, so
the two differ by at most 1 a pixel. `load_batch_plain` is the same
function in numpy, on the port's Python codecs (`data/png.py`,
`data/jpeg.py`): the yardstick of the tests and of chip_smoke.py, which
hold `load_batch` equal to it bit for bit.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ursonet_torch.data.dataset import load_image_rgb
from ursonet_torch.ops import cuda_build


def _bind(lib) -> None:
    c_int, p = ctypes.c_int, ctypes.c_void_p
    lib.ursonet_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), c_int, p, c_int, c_int, c_int,
        c_int, c_int, c_int, c_int]
    lib.ursonet_load_batch.restype = c_int
    lib.ursonet_decode.argtypes = [ctypes.c_char_p, p, ctypes.c_long,
                                   ctypes.POINTER(c_int),
                                   ctypes.POINTER(c_int)]
    lib.ursonet_decode.restype = c_int


def _lib() -> ctypes.CDLL:
    return cuda_build.load("host_loader", _bind)


def _check_geometry(out_h, out_w, content_h, content_w, top, left) -> None:
    if min(content_h, content_w) < 1 or min(top, left) < 0 \
            or top + content_h > out_h or left + content_w > out_w:
        raise ValueError(f"a {content_h}x{content_w} window at ({top}, "
                         f"{left}) does not fit a {out_h}x{out_w} image")


def load_batch(paths, out_h: int, out_w: int, content_h: int,
               content_w: int, top: int, left: int,
               nthreads: int = 0) -> np.ndarray:
    """Decode `paths` and return a [N, out_h, out_w, 3] uint8 batch with
    each image resized to (content_h, content_w) at offset (top, left),
    zero padding elsewhere, on `nthreads` threads (<= 0: min(N, the
    host's CPUs)). Raises RuntimeError naming a file that failed."""
    _check_geometry(out_h, out_w, content_h, content_w, top, left)
    lib = _lib()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    rc = lib.ursonet_load_batch(arr, n, out.ctypes.data, out_h, out_w,
                                content_h, content_w, top, left, nthreads)
    if rc:
        raise RuntimeError(f"native decode failed for {paths[rc - 1]}")
    return out


def decode(path: str, max_h: int = 4096, max_w: int = 6144) -> np.ndarray:
    """Decode one image at its own size to RGB uint8 (at most
    max_h * max_w pixels)."""
    lib = _lib()
    buf = np.empty((max_h * max_w * 3,), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.ursonet_decode(os.fsencode(path), buf.ctypes.data, buf.size,
                            ctypes.byref(h), ctypes.byref(w))
    if rc:
        raise RuntimeError(f"native decode failed ({rc}) for {path}")
    return buf[:h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def _axis(n_out: int, n_src: int, scale: np.float32):
    """Source indices (lo, hi) and float32 weights along one axis, as
    resize_into computes them: floor of (i + 0.5) * scale - 0.5, clamped
    at both edges with the weight then 0."""
    f32 = np.float32
    s = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    lo = np.floor(s).astype(np.int64)
    t = (s - lo.astype(f32)).astype(f32)
    low = lo < 0
    lo[low], t[low] = 0, 0
    high = lo >= n_src - 1
    lo[high], t[high] = n_src - 1, 0
    return lo, np.minimum(lo + 1, n_src - 1), t


def resize_plain(image: np.ndarray, content_h: int,
                 content_w: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [content_h, content_w, 3] uint8: resize_into's
    float32 arithmetic in numpy, each product and sum rounded on its own,
    the value truncated."""
    f32 = np.float32
    h, w = image.shape[:2]
    y0, y1, ty = _axis(content_h, h, f32(h) / f32(content_h))
    x0, x1, tx = _axis(content_w, w, f32(w) / f32(content_w))
    src = image.astype(np.int32)
    tx = tx[None, :, None]
    ty = ty[:, None, None]

    def lerp_x(rows):
        a, b = rows[:, x0], rows[:, x1]
        return a.astype(f32) + (b - a).astype(f32) * tx

    top, bot = lerp_x(src[y0]), lerp_x(src[y1])
    return (top + (bot - top) * ty).astype(np.uint8)


def load_batch_plain(paths, out_h: int, out_w: int, content_h: int,
                     content_w: int, top: int, left: int) -> np.ndarray:
    """`load_batch` in numpy on the port's Python codecs: the same
    batch, bit for bit. Raises what the codecs raise for a bad file."""
    _check_geometry(out_h, out_w, content_h, content_w, top, left)
    out = np.zeros((len(paths), out_h, out_w, 3), np.uint8)
    for i, path in enumerate(paths):
        out[i, top:top + content_h, left:left + content_w] = resize_plain(
            load_image_rgb(path), content_h, content_w)
    return out
