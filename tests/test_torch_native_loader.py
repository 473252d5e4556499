"""The port's native batch loader (`ursonet_torch/data/native_loader.py`
over `csrc/host_loader.cpp`) against the JAX package's
(`ursonet_tpu/data/native_loader.py` over `native/host_loader.cpp`, which
links libjpeg and libpng), against its own numpy version
(`load_batch_plain`) and against the Python path, on the CPU; and the
native route of `data_generator` against the JAX package's.

Tolerances: the JAX native loader and `load_batch_plain` exactly (the
same decoders' pixels and the same float32 resize, truncated); the
Python path (cv2's rounding resize) within 1 a value, the bound
tests/test_data.py holds the JAX package's two routes to.
"""

import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ursonet_tpu.data import loader as jloader
from ursonet_tpu.data import native_loader as jnative
from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_torch.data import loader as tloader
from ursonet_torch.data import native_loader as nl
from ursonet_torch.data import png
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Camera, Urso
from ursonet_torch.ops import cuda_build
from ursonet_torch.ops import image as timage
from torch_parity import small_configs

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')
FIXTURES = ['fixture_rgba.png', 'jpeg_gray.jpg', 'jpeg_rgb420.jpg',
            'fixture_gray_speed_crop.jpg']


@pytest.fixture(scope='module')
def jax_native():
    if not jnative.available():
        pytest.fail("the JAX package's native loader did not build (g++, "
                    "libjpeg, libpng)")
    return jnative


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """PNG frames written by the port's encoder (RGB with each of the five
    row filters, gray, and RGBA) and the committed PNG and JPEG
    fixtures, by name."""
    d = tmp_path_factory.mktemp('native_files')
    rng = np.random.RandomState(0)
    out = {}
    for name, shape, ft in (('rgb_f0', (37, 53, 3), 0),
                            ('rgb_f1', (48, 64, 3), 1),
                            ('rgb_f2', (40, 30, 3), 2),
                            ('rgb_f3', (64, 80, 3), 3),
                            ('rgb_f4', (33, 47, 3), 4),
                            ('gray', (40, 30), 1),
                            ('rgba', (25, 31, 4), 4)):
        a = rng.randint(0, 256, shape).astype(np.uint8)
        a[2:6] = np.linspace(0, 255, shape[1], dtype=np.uint8)[
            (slice(None),) + (None,) * (len(shape) - 2)]  # a smooth band
        path = str(d / f'{name}.png')
        with open(path, 'wb') as f:
            f.write(png.encode_png(a, ft))
        out[name] = path
    for name in FIXTURES:
        out[name] = os.path.join(DATA, name)
    return out


@pytest.mark.parametrize('name', ['rgb_f0', 'rgb_f3', 'rgb_f4', 'gray',
                                  'rgba'] + FIXTURES)
def test_decode_matches_jax(jax_native, files, name):
    got = nl.decode(files[name])
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, jax_native.decode(files[name]))


# (out_h, out_w, content_h, content_w, top, left)
GEOMETRIES = {
    'scaled, padded': (64, 64, 48, 60, 8, 2),
    'upscaled, padded': (100, 120, 70, 110, 13, 5),
    'no pad': (32, 40, 32, 40, 0, 0),
}


@pytest.mark.parametrize('nthreads', [1, 4])
@pytest.mark.parametrize('geom', sorted(GEOMETRIES))
def test_load_batch_matches_jax_and_plain(jax_native, files, geom,
                                          nthreads):
    paths = list(files.values())
    g = GEOMETRIES[geom]
    got = nl.load_batch(paths, *g, nthreads=nthreads)
    assert got.shape == (len(paths), g[0], g[1], 3)
    np.testing.assert_array_equal(got, jax_native.load_batch(
        paths, *g, nthreads=nthreads))
    np.testing.assert_array_equal(got, nl.load_batch_plain(paths, *g))


def test_identity_geometry_copies_the_pixels(jax_native, files):
    """At the files' own size and no offset the batch is the decode."""
    paths = [files['rgb_f1'], files['fixture_rgba.png']]   # both 48x64
    got = nl.load_batch(paths, 48, 64, 48, 64, 0, 0, nthreads=2)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[i], nl.decode(p))
    np.testing.assert_array_equal(got, jax_native.load_batch(
        paths, 48, 64, 48, 64, 0, 0))


def test_within_one_of_the_python_path(tmp_path):
    """URSO frames through the native route and through the Python path
    of the same generator: the same ids, poses, shape and window, pixels
    within 1. The native route's meta names the camera's frame size and
    scale (1280x960, as the JAX package's native route), the Python
    path's the frame's own (160x120)."""
    d = str(tmp_path / 'urso')
    make_urso_dataset(d, subsets=('train',), n_per_subset=4, width=160,
                      height=120)
    _, cfg = small_configs(mode='square', dim=128, IMAGES_PER_GPU=4)
    ds = Urso()
    ds.load_dataset(d, cfg, 'train')
    native = next(tloader.data_generator(ds, cfg, shuffle=False,
                                         batch_size=4, seed=0))
    cfg.NATIVE_LOADER = False
    python = next(tloader.data_generator(ds, cfg, shuffle=False,
                                         batch_size=4, seed=0))
    assert native.keys() == python.keys()
    diff = np.abs(native['images_u8'].astype(int)
                  - python['images_u8'].astype(int))
    assert diff.max() <= 1, diff.max()
    for k in native:
        if k not in ('images_u8', 'image_meta'):
            np.testing.assert_array_equal(native[k], python[k], err_msg=k)
    cols = [0] + list(range(4, 11))      # id, shape, window
    np.testing.assert_array_equal(native['image_meta'][:, cols],
                                  python['image_meta'][:, cols])


def test_geometry_comes_from_the_probe():
    ds = SimpleNamespace(camera=Camera())       # 1280x960
    _, cfg = small_configs(mode='pad64', dim=192, IMAGE_MIN_DIM=128)
    g = tloader.native_geometry(ds, cfg)
    shape, window, scale = timage.resize_geometry(
        960, 1280, min_dim=128, max_dim=192, mode='pad64')
    assert (g['out_h'], g['out_w']) == shape
    assert (g['top'], g['left'], g['top'] + g['content_h'],
            g['left'] + g['content_w']) == tuple(window)
    assert g['scale'] == scale
    cfg.NATIVE_LOADER = False
    assert tloader.native_geometry(ds, cfg) is None
    _, cfg = small_configs(mode='crop')
    assert tloader.native_geometry(ds, cfg) is None


def _corrupt(path, tmp_path, name='bad.png'):
    """A copy of a PNG frame with one IDAT byte flipped (its CRC fails)."""
    data = bytearray(open(path, 'rb').read())
    data[data.index(b'IDAT') + 8] ^= 0xFF
    bad = str(tmp_path / name)
    with open(bad, 'wb') as f:
        f.write(bytes(data))
    return bad


def test_a_failing_file_is_named(jax_native, files, tmp_path):
    bad = _corrupt(files['rgb_f1'], tmp_path)
    paths = [files['rgb_f0'], files['gray'], bad, files['rgba']]
    for mod in (nl, jax_native):
        with pytest.raises(RuntimeError, match='bad.png'):
            mod.load_batch(paths, 32, 32, 32, 32, 0, 0, nthreads=1)
    missing = str(tmp_path / 'missing.png')
    with pytest.raises(RuntimeError, match='missing.png'):
        nl.load_batch([files['gray'], missing], 32, 32, 32, 32, 0, 0)
    with pytest.raises(RuntimeError, match='bad.png'):
        nl.decode(bad)
    with pytest.raises(ValueError, match='CRC'):
        nl.load_batch_plain(paths, 32, 32, 32, 32, 0, 0)
    with pytest.raises(ValueError, match='does not fit'):
        nl.load_batch(paths, 32, 32, 30, 32, 3, 0)


@pytest.fixture(scope='module')
def urso_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso_native'))
    make_urso_dataset(d, subsets=('train',), n_per_subset=8, width=96,
                      height=72)
    return d


def test_data_generator_matches_jax_native_route(jax_native, urso_dir):
    """The first 6 batches of both packages' native routes: the same ids
    (RandomState shuffle), pixels, image meta and poses."""
    jcfg, tcfg = small_configs(NATIVE_LOADER=True, IMAGES_PER_GPU=3,
                               mode='pad64', dim=128)
    jds, tds = JaxUrso(), Urso()
    jds.load_dataset(urso_dir, jcfg, 'train')
    tds.load_dataset(urso_dir, tcfg, 'train')
    jgen = jloader.data_generator(jds, jcfg, shuffle=True, batch_size=3,
                                  seed=5, raw=True)
    tgen = tloader.data_generator(tds, tcfg, shuffle=True, batch_size=3,
                                  seed=5)
    for _ in range(6):
        want, got = next(jgen), next(tgen)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want['images_u8'].shape == (3, 128, 128, 3)


def test_generator_skips_failed_batches_then_raises(urso_dir, tmp_path):
    """A batch with a bad frame is logged and skipped (its ids are spent);
    the sixth failed batch raises."""
    _, tcfg = small_configs(IMAGES_PER_GPU=2)
    tds = Urso()
    tds.load_dataset(urso_dir, tcfg, 'train')
    good = list(tds.image_info)
    bad = _corrupt(good[1]['path'], tmp_path)
    tds.image_info = [dict(i, path=bad) if n == 1 else i
                      for n, i in enumerate(good)]
    gen = tloader.data_generator(tds, tcfg, shuffle=False, batch_size=2,
                                 seed=0)
    np.testing.assert_array_equal(next(gen)['image_meta'][:, 0], [2, 3])
    tds.image_info = [dict(i, path=bad) for i in good]
    gen = tloader.data_generator(tds, tcfg, shuffle=False, batch_size=2,
                                 seed=0)
    with pytest.raises(RuntimeError, match='bad.png'):
        next(gen)


def test_library_name_hashes_headers_and_link_flags(monkeypatch, tmp_path):
    """An edit of a header that a host source includes, or of its link
    flags, names another library; a header it does not include does
    not."""
    csrc = tmp_path / 'csrc'
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, 'CSRC', csrc)
    before = {n: cuda_build.library_path(n)
              for n in ('host_loader', 'jpeg', 'int8_gemm')}
    assert [h.name for h in cuda_build.local_headers(
        csrc / 'host_loader.cpp')] == ['jpeg_codec.h']
    with open(csrc / 'jpeg_codec.h', 'a') as f:
        f.write('\n// edited\n')
    after = {n: cuda_build.library_path(n) for n in before}
    assert after['host_loader'] != before['host_loader']
    assert after['jpeg'] != before['jpeg']
    assert after['int8_gemm'] == before['int8_gemm']
    monkeypatch.setitem(cuda_build.HOST_LINK, 'host_loader', ('-lz',))
    assert cuda_build.library_path('host_loader') != after['host_loader']


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                          files):
    """No quiet fallback: when g++ refuses, the loader raises
    RuntimeError with its output."""
    monkeypatch.setattr(cuda_build, 'GXX_FLAGS',
                        cuda_build.GXX_FLAGS + ('-fno-such-flag-here',))
    monkeypatch.setattr(cuda_build, '_libs', {})
    with pytest.raises(RuntimeError, match='(?s)failed.*no-such-flag'):
        nl.load_batch([files['gray']], 8, 8, 8, 8, 0, 0)


def test_threads_that_load_at_once_share_one_build(monkeypatch, tmp_path):
    """A streamed epoch's train and validation prefetchers both load the
    native loader at their first batch: threads that ask for a library
    that is not built yet all get the one build, and none fails (a
    failure there drops a batch and shifts the stream)."""
    import threading

    monkeypatch.setattr(cuda_build, 'BUILD_DIR', tmp_path / 'ext')
    monkeypatch.setattr(cuda_build, '_libs', {})
    got, errors = [], []
    start = threading.Barrier(4)

    def load():
        start.wait()
        try:
            got.append(cuda_build.load('host_loader', nl._bind))
        except Exception as e:      # noqa: BLE001 (reported below)
            errors.append(repr(e))
    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and len(got) == 4
    assert all(lib is got[0] for lib in got)
    assert [p.name for p in (tmp_path / 'ext').iterdir()] \
        == [cuda_build.library_path('host_loader').name]
