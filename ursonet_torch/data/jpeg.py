"""Baseline JPEG decode and gray encode on the port's own codec
(`ursonet_torch/csrc/jpeg.cpp`, host C++ with no libjpeg), the
counterpart of the JPEG half of `native/host_loader.cpp`.

    decode_jpeg(data) -> [H, W] uint8 (one component) or [H, W, 3] RGB
    encode_jpeg(image, quality=75) -> bytes    ([H, W] gray or [H, W, 3] RGB)

The decoder gives PIL's pixels bit for bit (libjpeg-turbo's defaults:
the integer IDCT, fancy upsampling, its YCbCr tables) for baseline
Huffman-coded files; a scan without Huffman tables (the Motion-JPEG
frames of AVI files) takes the standard ones of ITU-T T.81 Annex K.3;
any other kind raises ValueError naming the feature. The encoder writes
the quantized coefficients PIL writes for a mode-L image at the same
quality; an RGB image becomes baseline YCbCr 4:2:0 with the Annex K
luminance and chrominance tables (libjpeg's conversion and
downsampling).

The library is built with g++ at first use into `.torch_ext/`
(`ops/cuda_build.py`); a failed build raises RuntimeError with the
compiler's message. ctypes releases the GIL for each call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ursonet_torch.ops import cuda_build

_ERR_LEN = 256


def _bind(lib) -> None:
    char_p, size_t, c_int = ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int
    int_p = ctypes.POINTER(c_int)
    lib.ursonet_jpeg_info.argtypes = [char_p, size_t, int_p, int_p, int_p,
                                      ctypes.c_void_p, c_int]
    lib.ursonet_jpeg_info.restype = c_int
    lib.ursonet_jpeg_decode.argtypes = [char_p, size_t, ctypes.c_void_p,
                                        size_t, ctypes.c_void_p, c_int]
    lib.ursonet_jpeg_decode.restype = c_int
    lib.ursonet_jpeg_encode_gray.argtypes = [
        ctypes.c_void_p, c_int, c_int, c_int, ctypes.c_void_p, size_t,
        ctypes.c_void_p, c_int]
    lib.ursonet_jpeg_encode_gray.restype = ctypes.c_int64
    lib.ursonet_jpeg_encode_rgb.argtypes = \
        lib.ursonet_jpeg_encode_gray.argtypes
    lib.ursonet_jpeg_encode_rgb.restype = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    return cuda_build.load("jpeg", _bind)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG: [H, W] uint8 for one component, [H, W, 3]
    RGB for three."""
    lib = _lib()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.ursonet_jpeg_info(data, len(data), ctypes.byref(h),
                             ctypes.byref(w), ctypes.byref(c), err,
                             _ERR_LEN):
        raise ValueError(f"JPEG: {err.value.decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    if lib.ursonet_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                               err, _ERR_LEN):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out


def encode_jpeg(image: np.ndarray, quality: int = 75) -> bytes:
    """Encode an [H, W] uint8 image as a baseline gray JPEG, or an
    [H, W, 3] uint8 RGB image as a baseline YCbCr 4:2:0 one."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes an [H, W] or [H, W, 3] uint8 "
                         f"image, got {image.shape} {image.dtype}")
    image = np.ascontiguousarray(image)
    lib = _lib()
    fn = lib.ursonet_jpeg_encode_gray if image.ndim == 2 \
        else lib.ursonet_jpeg_encode_rgb
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = image.shape[:2]
    out = np.empty(image.size + 4096, np.uint8)
    while True:
        n = fn(image.ctypes.data, h, w, int(quality), out.ctypes.data,
               out.nbytes, err, _ERR_LEN)
        if n < 0:
            raise ValueError(f"JPEG: {err.value.decode()}")
        if n <= out.nbytes:
            return out[:n].tobytes()
        out = np.empty(n, np.uint8)   # did not fit: once more, large enough
