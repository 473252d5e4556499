"""The port's JPEG codec (`ursonet_torch/csrc/jpeg.cpp` through
`ursonet_torch/data/jpeg.py`, built with g++ here) against PIL, whose
decoder and encoder are libjpeg-turbo's.

Tolerances: none. The decoder gives PIL's pixels bit for bit on gray,
4:4:4, 4:2:2 and 4:2:0 files at several qualities, odd sizes, restart
intervals and optimized Huffman tables, on one 1920x1200 frame and on
the JAX package's SPEED frames. The encoder writes PIL's quantization
table and PIL's quantized coefficients: PIL decodes the port's file and
its own to identical pixels. What the decoder does not take raises
ValueError naming it; a failed build raises with the compiler's message.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from ursonet_torch.data import jpeg
from ursonet_torch.data.dataset import load_image_rgb
from ursonet_torch.ops import cuda_build

SIZES = [(1, 1), (2, 5), (7, 13), (17, 23), (33, 1), (45, 77), (64, 48)]
# restart_marker_blocks / restart_marker_rows of PIL's writer
RESTARTS = [{}, {'restart_marker_blocks': 1},
            {'restart_marker_blocks': 3}, {'restart_marker_rows': 1}]
SUBSAMPLING = {'gray': None, '4:4:4': 0, '4:2:2': 1, '4:2:0': 2}


def _image(rng, h, w, channels):
    """Smooth structure plus noise: every coefficient band is used."""
    y, x = np.mgrid[0:h, 0:w]
    planes = [np.sin(x / 7.0 + k) * 60 + np.cos(y / 5.0 - k) * 50 + 128
              + rng.randn(h, w) * 20 for k in range(channels)]
    a = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    return a[..., 0] if channels == 1 else a


def _pil_file(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG', **kw)
    return buf.getvalue()


def _pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize('quality', [50, 75, 95])
@pytest.mark.parametrize('kind', list(SUBSAMPLING))
def test_decoder_equals_pil(kind, quality):
    rng = np.random.RandomState(quality)
    for h, w in SIZES:
        arr = _image(rng, h, w, 1 if kind == 'gray' else 3)
        for extra in RESTARTS + [{'optimize': True}]:
            kw = {'quality': quality, **extra}
            if SUBSAMPLING[kind] is not None:
                kw['subsampling'] = SUBSAMPLING[kind]
            data = _pil_file(arr, **kw)
            got, want = jpeg.decode_jpeg(data), _pil_pixels(data)
            assert got.shape == want.shape, (h, w, kw)
            np.testing.assert_array_equal(got, want, err_msg=str((h, w, kw)))


@pytest.mark.parametrize('kind', ['gray', '4:2:0'])
def test_decoder_equals_pil_on_a_speed_sized_frame(kind):
    arr = _image(np.random.RandomState(1), 1200, 1920,
                 1 if kind == 'gray' else 3)
    kw = {} if kind == 'gray' else {'subsampling': 2}
    data = _pil_file(arr, **kw)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil_pixels(data))


def test_decoder_equals_pil_on_the_jax_speed_frames(tmp_path):
    from ursonet_tpu.data.synthetic import make_speed_dataset
    d = str(tmp_path / 'speed')
    make_speed_dataset(d, n_per_subset=2, seed=4)
    frames = sorted(os.path.join(r, f) for r, _, fs in os.walk(d)
                    for f in fs if f.endswith('.jpg'))
    assert len(frames) == 8
    for path in frames:
        with open(path, 'rb') as f:
            data = f.read()
        want = _pil_pixels(data)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
        # load_image_rgb replicates gray frames to three channels
        np.testing.assert_array_equal(load_image_rgb(path),
                                      np.repeat(want[..., None], 3, 2))


@pytest.mark.parametrize('quality', [50, 75, 95])
def test_encoder_writes_pils_coefficients(quality):
    rng = np.random.RandomState(quality + 1)
    for h, w in SIZES + [(200, 320)]:
        arr = _image(rng, h, w, 1)
        mine = jpeg.encode_jpeg(arr, quality)
        pil = _pil_file(arr, quality=quality)
        np.testing.assert_array_equal(_pil_pixels(mine), _pil_pixels(pil),
                                      err_msg=str((h, w)))
        assert Image.open(io.BytesIO(mine)).quantization == \
            Image.open(io.BytesIO(pil)).quantization
        # and the port's decoder reads its own files
        np.testing.assert_array_equal(jpeg.decode_jpeg(mine),
                                      _pil_pixels(mine))


def test_encoder_default_quality_is_pils():
    arr = _image(np.random.RandomState(5), 40, 56, 1)
    np.testing.assert_array_equal(_pil_pixels(jpeg.encode_jpeg(arr)),
                                  _pil_pixels(_pil_file(arr)))
    with pytest.raises(ValueError, match='uint8'):
        jpeg.encode_jpeg(arr.astype(np.float32))
    with pytest.raises(ValueError, match=r'\[H, W\]'):
        jpeg.encode_jpeg(np.zeros((4, 4, 2), np.uint8))


def _with_sof(data: bytes, marker: int = None, precision: int = None):
    """`data` with its SOF0 marker replaced and/or its precision byte
    changed."""
    i = data.index(b'\xff\xc0')
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


@pytest.mark.parametrize('make,match', [
    (lambda a: _pil_file(a, progressive=True), 'progressive'),
    (lambda a: _with_sof(_pil_file(a), marker=0xC3), 'lossless'),
    (lambda a: _with_sof(_pil_file(a), marker=0xC5), 'hierarchical'),
    (lambda a: _with_sof(_pil_file(a), marker=0xC9), 'arithmetic'),
    (lambda a: _with_sof(_pil_file(a), precision=12), '12-bit'),
    (lambda a: _cmyk(a), 'four-component'),
    (lambda a: b'\x89PNG\r\n\x1a\n', 'not a JPEG'),
    (lambda a: _pil_file(a)[:200], 'corrupt data'),
])
def test_what_the_decoder_does_not_take_raises(make, match):
    arr = _image(np.random.RandomState(2), 24, 40, 1)
    with pytest.raises(ValueError, match=match):
        jpeg.decode_jpeg(make(arr))


def _cmyk(gray):
    buf = io.BytesIO()
    Image.fromarray(np.stack([gray] * 4, -1), mode='CMYK').save(buf, 'JPEG')
    return buf.getvalue()


def test_load_image_rgb_names_the_file_of_a_bad_jpeg(tmp_path):
    path = str(tmp_path / 'p.jpg')
    with open(path, 'wb') as f:
        f.write(_pil_file(_image(np.random.RandomState(3), 16, 16, 1),
                          progressive=True))
    with pytest.raises(ValueError, match='p.jpg.*progressive'):
        load_image_rgb(path)


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch):
    """No fallback: when g++ refuses, decoding raises RuntimeError with
    its output (a bad flag here; the hash of the flags names another
    library, so no earlier build is taken)."""
    monkeypatch.setattr(cuda_build, 'GXX_FLAGS',
                        cuda_build.GXX_FLAGS + ('-fno-such-flag-here',))
    monkeypatch.setattr(cuda_build, '_libs', {})
    data = _pil_file(_image(np.random.RandomState(4), 8, 8, 1))
    with pytest.raises(RuntimeError, match='(?s)failed.*no-such-flag'):
        jpeg.decode_jpeg(data)
