"""PNG codec on the standard library's zlib and numpy: the port's
replacement for what the JAX package reads and writes through PIL
(`ursonet_tpu/data/dataset.py::load_image_rgb`, `data/synthetic.py`).

`decode_png` reads 8-bit grayscale, RGB and RGBA images, not interlaced,
with any of the five row filters. Runs of rows with the same filter are
undone together: None and Sub rows are independent of the rows above
(Sub is a wrapping cumulative sum along the row), and a run of Up rows
is a wrapping cumulative sum down the columns added to the row before
it. Average and Paeth depend on the byte to the left as it is being
reconstructed, so they loop over the bytes of each row in Python,
orders of magnitude slower (chip_smoke.py prints the time of a
1280×960 frame per filter). `encode_png` writes one filter on every
row, by default 1 (Sub), so the port's own frames decode on the fast
path; the other four are there to test the decoder. Anything else
(palette, 16-bit, gray with alpha, interlace) raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# color type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    """(type, payload) of each chunk, its CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file')
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError('truncated PNG chunk header')
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError('truncated PNG chunk')
        if zlib.crc32(kind + body) != struct.unpack('>I', crc)[0]:
            raise ValueError(f'bad CRC in PNG chunk {kind!r}')
        yield kind, body
        pos += 12 + n
        if kind == b'IEND':
            return
    raise ValueError('PNG without IEND')


def _unfilter_avg(filt, prev, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prev[i]) >> 1)) & 0xFF
    return out


def _unfilter_paeth(filt, prev, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        if i >= bpp:
            a, c = out[i - bpp], prev[i - bpp]
        else:
            a = c = 0
        b = prev[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(rows: np.ndarray, width: int, bpp: int) -> np.ndarray:
    """rows [H, 1 + stride] uint8 (filter byte first) -> [H, stride]."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    ftype = rows[:, 0]
    filt = rows[:, 1:]
    bad = sorted(set(np.unique(ftype).tolist()) - {0, 1, 2, 3, 4})
    if bad:
        raise ValueError(f'unknown PNG row filter {bad[0]}')
    out = np.empty((h, stride), np.uint8)
    starts = np.flatnonzero(np.diff(ftype.astype(np.int16))) + 1
    for r, e in zip([0] + starts.tolist(), starts.tolist() + [h]):
        t = int(ftype[r])
        if t == 0:
            out[r:e] = filt[r:e]
        elif t == 1:
            out[r:e] = np.cumsum(filt[r:e].reshape(e - r, width, bpp), axis=1,
                                 dtype=np.uint8).reshape(e - r, stride)
        elif t == 2:
            prev = out[r - 1] if r else np.zeros(stride, np.uint8)
            out[r:e] = np.cumsum(filt[r:e], axis=0, dtype=np.uint8) + prev
        else:
            fn = _unfilter_avg if t == 3 else _unfilter_paeth
            zero = bytes(stride)
            for i in range(r, e):
                prev = out[i - 1].tobytes() if i else zero
                out[i] = np.frombuffer(fn(filt[i].tobytes(), prev, bpp),
                                       np.uint8)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] (gray) or [H, W, C] (RGB, RGBA) uint8."""
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG without IHDR')
    width, height, depth, ctype, comp, filt_method, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f'unsupported PNG: bit depth {depth}, color type '
                         f'{ctype} (8-bit gray, RGB and RGBA only)')
    if comp != 0 or filt_method != 0 or interlace != 0:
        raise ValueError('unsupported PNG: interlaced or unknown method')
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != height * (1 + width * ch):
        raise ValueError('PNG image data has the wrong size')
    img = _unfilter(raw.reshape(height, 1 + width * ch), width, ch)
    img = img.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _filter(rows: np.ndarray, filter_type: int, bpp: int) -> np.ndarray:
    """The PNG filter `filter_type` applied to every row of [H, stride]
    uint8 (the forward direction, from the original bytes)."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                            # up
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    else:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]           # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(image: np.ndarray, filter_type: int = 1,
               level: int = 6) -> bytes:
    """[H, W] or [H, W, C] uint8 (C = 1, 3, 4) -> PNG bytes, every row
    with filter `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f'encode_png takes uint8, got {img.dtype}')
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f'encode_png takes [H,W], [H,W,3] or [H,W,4], got '
                         f'{np.shape(image)}')
    if filter_type not in (0, 1, 2, 3, 4):
        raise ValueError(f'unknown PNG row filter {filter_type}')
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    raw = np.empty((h, 1 + w * ch), np.uint8)
    raw[:, 0] = filter_type
    raw[:, 1:] = _filter(img.reshape(h, w * ch), filter_type, ch)
    ihdr = struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(raw.tobytes(), level))
            + _chunk(b'IEND', b''))


def write_png(path: str, image: np.ndarray, filter_type: int = 1) -> None:
    with open(path, 'wb') as f:
        f.write(encode_png(image, filter_type))
