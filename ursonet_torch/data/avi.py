"""Motion-JPEG video in AVI (RIFF) files, read and written by the port's
own code: the card's machine has neither cv2 nor ffmpeg, which
`ursonet_tpu/video.py` reads and writes frames through.

    AviReader(path)        .fps, .width, .height, .frames (count from
                           the header), iteration: [H, W, 3] uint8 RGB
                           frames ([H, W] for gray frames), .close()
    AviWriter(path, fps)   .append(frame [H, W, 3] uint8 RGB), .close()

The reader walks the RIFF tree: 'avih' (frame count, size), the first
video stream's 'strh' (fps = dwRate / dwScale) and 'strf' (the
BITMAPINFOHEADER's compression), then the 'movi' list's '##dc' chunks in
order, also inside 'LIST rec ' groups, skipping 'JUNK' and every other
chunk, each chunk padded to an even size. Each frame is a baseline JPEG
(`data/jpeg.py`; a frame without Huffman tables takes the standard ones,
the MJPEG convention). A stream whose fourcc is not MJPG raises
ValueError naming it, as does an OpenDML file (a second RIFF 'AVIX'
list, which AVI files past 1 GB need).

The writer writes one MJPG stream (frames encoded by `encode_jpeg`,
YCbCr 4:2:0 at `quality`), an 'idx1' index of key frames, and the
header's counts once it is closed; a frame that would take the file
past the 1 GB limit of a RIFF list raises ValueError (no OpenDML).
"""

from __future__ import annotations

import struct
from fractions import Fraction

import numpy as np

from ursonet_torch.data.jpeg import decode_jpeg, encode_jpeg

RIFF_LIMIT = 1 << 30          # bytes of a RIFF list without OpenDML
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunks(f, end):
    """(fourcc, size, data offset) of the chunks of f from its position
    to `end`, each skipped to its padded end after it is yielded."""
    while f.tell() + 8 <= end:
        head = f.read(8)
        if len(head) < 8:
            return
        fourcc, size = head[:4], struct.unpack('<I', head[4:])[0]
        start = f.tell()
        yield fourcc, size, start
        f.seek(start + size + (size & 1))


class AviReader:
    """Frames of an MJPG AVI file (module docstring)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, 'rb')
        try:
            self._parse()
        except Exception:
            self._f.close()
            raise

    def _parse(self):
        f = self._f
        f.seek(0, 2)
        file_end = f.tell()
        f.seek(0)
        head = f.read(12)
        if len(head) < 12 or head[:4] != b'RIFF' or head[8:] != b'AVI ':
            raise ValueError(f"{self.path}: not an AVI (RIFF 'AVI ') file")
        riff_end = min(8 + struct.unpack('<I', head[4:8])[0], file_end)
        self.fps, self.width, self.height, self.frames = 25.0, 0, 0, 0
        self._stream, self._movi = None, None
        for fourcc, size, start in _chunks(f, riff_end):
            if fourcc == b'LIST':
                kind = f.read(4)
                if kind == b'hdrl':
                    self._hdrl(start + 4, start + size)
                elif kind == b'movi':
                    self._movi = (start + 4, start + size)
        if self._stream is None:
            raise ValueError(f"{self.path}: no video stream")
        if self._movi is None:
            raise ValueError(f"{self.path}: no 'movi' list")
        f.seek(riff_end + (riff_end & 1))
        more = f.read(12)
        if len(more) == 12 and more[:4] == b'RIFF' and more[8:] == b'AVIX':
            raise ValueError(f"{self.path}: an OpenDML (AVIX) AVI file, "
                             "which this reader does not take")

    def _hdrl(self, pos, end):
        f = self._f
        f.seek(pos)
        for fourcc, size, start in _chunks(f, end):
            if fourcc == b'avih' and size >= 40:
                v = struct.unpack('<10I', f.read(40))
                self.frames, self.width, self.height = v[4], v[8], v[9]
            elif fourcc == b'LIST' and f.read(4) == b'strl' \
                    and self._stream is None:
                self._strl(start + 4, start + size)

    def _strl(self, pos, end):
        f = self._f
        f.seek(pos)
        kind = handler = compression = None
        scale = rate = 0
        for fourcc, size, _ in _chunks(f, end):
            if fourcc == b'strh' and size >= 36:
                d = f.read(36)
                kind, handler = d[:4], d[4:8]
                scale, rate = struct.unpack('<II', d[20:28])
            elif fourcc == b'strf' and size >= 20:
                d = f.read(20)
                compression = d[16:20]
        if kind != b'vids':
            return
        for cc in (compression, handler):
            if cc and cc.strip(b'\0 ') and cc.upper() != b'MJPG':
                raise ValueError(f"{self.path}: video fourcc "
                                 f"{cc.decode('latin-1')!r}: only MJPG is "
                                 "taken")
        self._stream = 0
        if scale and rate:
            self.fps = rate / scale

    def chunks(self):
        """The JPEG bytes of each video frame, in order."""
        f = self._f

        def walk(pos, end):
            f.seek(pos)
            for fourcc, size, start in _chunks(f, end):
                if fourcc == b'LIST':
                    if f.read(4) == b'rec ':
                        yield from walk(start + 4, start + size)
                elif fourcc[2:] == b'dc' and size:
                    yield f.read(size)

        yield from walk(*self._movi)

    def __iter__(self):
        for data in self.chunks():
            yield decode_jpeg(data)

    def close(self):
        self._f.close()


class AviWriter:
    """One MJPG stream at `fps` (module docstring)."""

    def __init__(self, path: str, fps: float, quality: int = 75):
        self.path, self.quality = path, int(quality)
        frac = Fraction(float(fps)).limit_denominator(1001)
        self._rate, self._scale = frac.numerator, frac.denominator
        self._f = open(path, 'wb')
        self._index = []          # (offset from 'movi', size)
        self._size = None
        self._max_chunk = 0

    def _header(self, n_frames):
        w, h = self._size
        usec = int(round(1e6 * self._scale / self._rate))
        avih = struct.pack('<14I', usec, 0, 0, _AVIF_HASINDEX, n_frames, 0,
                           1, self._max_chunk, w, h, 0, 0, 0, 0)
        strh = b'vidsMJPG' + struct.pack(
            '<IHHIIIIIIiI4h', 0, 0, 0, 0, self._scale, self._rate, 0,
            n_frames, self._max_chunk, -1, 0, 0, 0, w, h)
        strf = struct.pack('<IiiHH4sIiiII', 40, w, h, 1, 24, b'MJPG',
                           w * h * 3, 0, 0, 0, 0)
        strl = b'strl' + self._chunk(b'strh', strh) + self._chunk(b'strf',
                                                                  strf)
        hdrl = b'hdrl' + self._chunk(b'avih', avih) + self._chunk(b'LIST',
                                                                  strl)
        return self._chunk(b'LIST', hdrl)

    @staticmethod
    def _chunk(fourcc, data):
        return fourcc + struct.pack('<I', len(data)) + data \
            + (b'\0' if len(data) & 1 else b'')

    def append(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"AviWriter takes [H, W, 3] uint8 RGB frames, "
                             f"got {frame.shape} {frame.dtype}")
        h, w = frame.shape[:2]
        f = self._f
        if self._size is None:
            self._size = (w, h)
            f.write(b'RIFF\0\0\0\0AVI ')
            f.write(self._header(0))
            self._movi_at = f.tell() + 8     # the 'movi' fourcc
            f.write(b'LIST\0\0\0\0movi')
        elif self._size != (w, h):
            raise ValueError(f"frame of {w}x{h} in a {self._size[0]}x"
                             f"{self._size[1]} stream")
        data = encode_jpeg(frame, self.quality)
        pad = len(data) & 1
        # the chunk, the index entry and the index's header must fit
        end = f.tell() + 8 + len(data) + pad + 16 * (len(self._index) + 1) + 8
        if end > RIFF_LIMIT:
            raise ValueError(f"{self.path}: past the 1 GB limit of an AVI "
                             "RIFF list (OpenDML is not written)")
        self._index.append((f.tell() - self._movi_at, len(data)))
        f.write(b'00dc' + struct.pack('<I', len(data)) + data
                + (b'\0' if pad else b''))
        self._max_chunk = max(self._max_chunk, len(data))

    def close(self) -> None:
        f = self._f
        if self._size is not None:
            movi_end = f.tell()
            f.write(b'idx1' + struct.pack('<I', 16 * len(self._index)))
            for off, size in self._index:
                f.write(b'00dc' + struct.pack('<III', _AVIIF_KEYFRAME, off,
                                              size))
            end = f.tell()
            f.seek(4)
            f.write(struct.pack('<I', end - 8))
            f.write(b'AVI ')
            f.write(self._header(len(self._index)))
            f.seek(self._movi_at - 4)
            f.write(struct.pack('<I', movi_end - self._movi_at))
        f.close()
