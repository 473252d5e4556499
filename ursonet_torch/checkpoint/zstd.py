"""Zstandard frames for the Orbax store, on the port's own decoder
(`ursonet_torch/csrc/zstd.cpp`, host C++ with no libzstd).

    decompress(data) -> bytes     every frame of `data`, any zstd encoder's
    frame_raw(data) -> bytes      one frame of raw blocks, content size in
                                  its header
    crc32c(data) -> int           CRC-32C (Castagnoli), as OCDBT stores it

The decoder takes all of RFC 8878 but dictionaries: a frame that names
one, and any corrupt input, raises ValueError with the byte offset of the
fault. There is no compressing encoder: `frame_raw` stores the bytes in
raw blocks of at most 128 KiB, a frame any zstd reader takes (the store
writes it where the JAX package's writer compresses at level 1).

The library is built with g++ at first use into `.torch_ext/`
(`ops/cuda_build.py`); a failed build raises RuntimeError with the
compiler's message, so nothing here falls back to another decoder.
ctypes releases the GIL for each call.
"""

from __future__ import annotations

import ctypes
import struct

from ursonet_torch.ops import cuda_build

_ERR_LEN = 256
_BLOCK = 128 * 1024
_MAGIC = b'\x28\xb5\x2f\xfd'
# content size in 8 bytes, no checksum, no dictionary; multi-segment
_FHD = 0xC0
_WINDOW_128K = (17 - 10) << 3   # window descriptor: 2^17 bytes


def _bind(lib) -> None:
    char_p, size_t = ctypes.c_char_p, ctypes.c_size_t
    lib.ursonet_zstd_decompress.argtypes = [char_p, size_t, ctypes.c_uint64,
                                            ctypes.c_void_p, ctypes.c_int]
    lib.ursonet_zstd_decompress.restype = ctypes.c_void_p
    lib.ursonet_zstd_data.argtypes = [ctypes.c_void_p]
    lib.ursonet_zstd_data.restype = ctypes.c_void_p
    lib.ursonet_zstd_size.argtypes = [ctypes.c_void_p]
    lib.ursonet_zstd_size.restype = ctypes.c_uint64
    lib.ursonet_zstd_free.argtypes = [ctypes.c_void_p]
    lib.ursonet_zstd_free.restype = None
    lib.ursonet_crc32c.argtypes = [char_p, size_t, ctypes.c_uint32]
    lib.ursonet_crc32c.restype = ctypes.c_uint32


def _lib() -> ctypes.CDLL:
    return cuda_build.load("zstd", _bind)


def decompress(data: bytes, size_hint: int = 0) -> bytes:
    """The concatenated content of every zstd frame in `data`;
    `size_hint`, where the caller knows it, the decoded size (a frame
    without its content size then needs no growing buffer)."""
    lib = _lib()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h = lib.ursonet_zstd_decompress(data, len(data), size_hint, err,
                                    _ERR_LEN)
    if not h:
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(lib.ursonet_zstd_data(h),
                                lib.ursonet_zstd_size(h))
    finally:
        lib.ursonet_zstd_free(h)


def frame_raw(data: bytes) -> bytes:
    """One zstd frame holding `data` in raw blocks of at most 128 KiB,
    with the content size in its header."""
    data = memoryview(bytes(data))
    out = [_MAGIC, bytes([_FHD, _WINDOW_128K]), struct.pack('<Q', len(data))]
    n = len(data)
    for start in range(0, max(n, 1), _BLOCK):
        size = min(_BLOCK, n - start)
        last = start + _BLOCK >= n
        out.append((size << 3 | int(last)).to_bytes(3, 'little'))  # type 0
        out.append(data[start:start + size])
    return b''.join(out)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of `data`, continuing from `crc`."""
    data = bytes(data)
    return int(_lib().ursonet_crc32c(data, len(data), crc))
