"""The port's data path against the JAX package's: the PNG codec against
PIL, the resampler against the JAX `resize_image` (cv2), the encoders,
the URSO adapter, the synthetic generator, the raw batch generator and
the config files, on synthetic URSO dirs of 8 frames a subset at 96×72.

Tolerances: PNG decode and encode exact (every filter type); resize
exact at the URSO camera's 0.5 (1280×960 -> 640×480, pad64) and at the
other integer ratios; at other scales at most one step on at most
RESIZE_SHARE of the values (cv2 rounds its float products otherwise;
on the uniform noise of test_resize_matches_jax, the worst case: 0.0098%
at 130×100 -> 101×78, 0.84% at 1280×960 -> 800×600, none at 2/3, 2 and
8/15); adapter poses, keypoints, Euler angles,
angle-axis and PMFs within 1e-6, histogram map and mask exact, decoded
frames equal to PIL's; synthetic labels and CSV bytes exact; raw batches
exact.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ursonet_tpu.config import Config as JaxConfig
from ursonet_tpu.data import loader as jloader
from ursonet_tpu.data.synthetic import make_urso_dataset as jax_make_urso
from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_tpu.data.urso import encode_as_keypoints as jax_keypoints
from ursonet_tpu.ops import encoders as jenc
from ursonet_tpu.ops import image as jimage
from ursonet_torch.config import Config
from ursonet_torch.data import loader as tloader
from ursonet_torch.data import png
from ursonet_torch.data.dataset import load_image_rgb
from ursonet_torch.data.synthetic import make_urso_dataset, project, \
    render_intrinsics, _random_poses
from ursonet_torch.data.urso import MEAN_PIXEL, Urso, encode_as_keypoints
from ursonet_torch.ops import encoders as tenc
from ursonet_torch.ops import image as timage
from ursonet_torch import se3
from torch_parity import small_configs

torch.set_num_threads(1)

RESIZE_SHARE = 0.02
FRAME_W, FRAME_H = 96, 72


@pytest.fixture(scope='module')
def jax_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso_jax'))
    jax_make_urso(d, n_per_subset=8, width=FRAME_W, height=FRAME_H)
    return d


@pytest.fixture(scope='module')
def port_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso_port'))
    make_urso_dataset(d, n_per_subset=8, width=FRAME_W, height=FRAME_H)
    return d


def _pil_png(a, mode):
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, format='PNG')
    return buf.getvalue()


def _image(rng, shape):
    a = rng.randint(0, 256, shape).astype(np.uint8)
    a[3:9] = np.linspace(0, 255, shape[1], dtype=np.uint8)[
        (slice(None),) + (None,) * (len(shape) - 2)]   # a smooth band
    return a


# --------------------------------------------------------------------------
# PNG


@pytest.mark.parametrize('mode,shape', [('L', (23, 41)), ('RGB', (23, 41, 3)),
                                        ('RGBA', (23, 41, 4))])
def test_png_decodes_what_pil_writes(mode, shape):
    a = _image(np.random.RandomState(0), shape)
    np.testing.assert_array_equal(png.decode_png(_pil_png(a, mode)), a)


@pytest.mark.parametrize('shape', [(23, 41), (23, 41, 3), (23, 41, 4)])
@pytest.mark.parametrize('filter_type', [0, 1])
def test_pil_decodes_what_encode_png_writes(shape, filter_type):
    a = _image(np.random.RandomState(1), shape)
    got = np.asarray(Image.open(io.BytesIO(png.encode_png(a, filter_type))))
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize('filter_type', [0, 1, 2, 3, 4])
def test_png_filter_types_round_trip(filter_type):
    a = _image(np.random.RandomState(2), (31, 17, 3))
    data = png.encode_png(a, filter_type)
    np.testing.assert_array_equal(png.decode_png(data), a)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), a)


def test_png_mixed_filters_and_chunks():
    """Rows with different filters, split over several IDAT chunks, as
    other encoders write them."""
    import struct
    import zlib
    a = _image(np.random.RandomState(3), (40, 9, 3))
    rows = []
    for r in range(40):
        t = r % 5
        rows.append(np.concatenate([[t], png._filter(
            a.reshape(40, 27), t, 3)[r]]).astype(np.uint8))
    z = zlib.compress(np.stack(rows).tobytes())
    ihdr = struct.pack('>IIBBBBB', 9, 40, 8, 2, 0, 0, 0)
    data = png.SIGNATURE + png._chunk(b'IHDR', ihdr) + b''.join(
        png._chunk(b'IDAT', z[i:i + 50]) for i in range(0, len(z), 50)) \
        + png._chunk(b'IEND', b'')
    np.testing.assert_array_equal(png.decode_png(data), a)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), a)


def test_png_refuses_what_it_does_not_read():
    rng = np.random.RandomState(4)
    pal = Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)) \
        .convert('P')
    buf = io.BytesIO()
    pal.save(buf, format='PNG')
    with pytest.raises(ValueError, match='color type 3'):
        png.decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 65535, (8, 8)).astype(np.uint16)).save(
        buf, format='PNG')
    with pytest.raises(ValueError, match='bit depth 16'):
        png.decode_png(buf.getvalue())
    import struct
    good = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    adam7 = png.SIGNATURE + png._chunk(
        b'IHDR', struct.pack('>IIBBBBB', 4, 4, 8, 2, 0, 0, 1)) + good[33:]
    with pytest.raises(ValueError, match='interlaced'):
        png.decode_png(adam7)
    with pytest.raises(ValueError, match='CRC'):
        png.decode_png(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError):
        png.decode_png(b'GIF89a')
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4, 3), np.float32))


def test_load_image_rgb(tmp_path):
    rng = np.random.RandomState(5)
    gray = rng.randint(0, 256, (6, 7)).astype(np.uint8)
    rgba = rng.randint(0, 256, (6, 7, 4)).astype(np.uint8)
    png.write_png(str(tmp_path / 'g.png'), gray)
    png.write_png(str(tmp_path / 'a.png'), rgba)
    np.testing.assert_array_equal(load_image_rgb(str(tmp_path / 'g.png')),
                                  np.repeat(gray[..., None], 3, axis=2))
    np.testing.assert_array_equal(load_image_rgb(str(tmp_path / 'a.png')),
                                  rgba[..., :3])
    Image.fromarray(rgba[..., :3]).save(str(tmp_path / 'f.jpg'))
    with pytest.raises(NotImplementedError, match='native-loader'):
        load_image_rgb(str(tmp_path / 'f.jpg'))


# --------------------------------------------------------------------------
# resize, mold, meta


def test_resize_is_exact_at_the_urso_camera_scale():
    """1280×960 frames into benchmark_config(3)'s 512×640 pad64 shape:
    scale 0.5, then 16 rows of padding above and below."""
    img = np.random.RandomState(6).randint(0, 256, (960, 1280, 3)) \
        .astype(np.uint8)
    want = jimage.resize_image(img, min_dim=512, max_dim=640, min_scale=0,
                               mode='pad64')
    got = timage.resize_image(img, min_dim=512, max_dim=640, min_scale=0,
                              mode='pad64')
    assert got[0].shape == (512, 640, 3) and got[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])
    assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2] == 0.5
    assert got[3] == want[3]


@pytest.mark.parametrize('src,mode,lo,hi', [
    ((72, 96), 'square', 64, 64),        # 2/3, the tests' synthetic frames
    ((32, 32), 'square', 64, 64),        # upscale 2
    ((100, 130), 'square', 101, 101),    # 101/130
    ((960, 1280), 'square', 800, 800),   # 0.625
    ((120, 150, 1), 'pad64', 64, 128),   # one channel
])
def test_resize_matches_jax(src, mode, lo, hi):
    img = np.random.RandomState(7).randint(0, 256, src).astype(np.uint8)
    if len(src) == 3:
        img = img[..., 0]
    want = jimage.resize_image(img, min_dim=lo, max_dim=hi, mode=mode)
    got = timage.resize_image(img, min_dim=lo, max_dim=hi, mode=mode)
    assert got[0].shape == want[0].shape and got[0].dtype == np.uint8
    assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2]
    diff = np.abs(got[0].astype(int) - want[0].astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= RESIZE_SHARE
    ratio = want[2] if isinstance(want[2], float) else float(want[2])
    if abs(1 / ratio - round(1 / ratio)) < 1e-12 or ratio == 2:
        assert diff.max() == 0     # integer ratios are exact


def test_resize_crop_and_none_match_jax():
    import random
    img = np.random.RandomState(8).randint(0, 256, (64, 96, 3)) \
        .astype(np.uint8)
    for mode in ('none', 'crop'):     # crop: scale 0.5, then 32×32
        want = jimage.resize_image(img, min_dim=32, max_dim=64, mode=mode,
                                   rng=random.Random(3))
        got = timage.resize_image(img, min_dim=32, max_dim=64, mode=mode,
                                  rng=random.Random(3))
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(got[1]) == tuple(want[1]) and got[4] == want[4]
    with pytest.raises(ValueError):
        timage.resize_image(img, min_dim=32, max_dim=64, mode='bogus')


def test_mold_meta_and_pad_match_jax():
    jcfg, tcfg = small_configs()
    img = np.random.RandomState(9).randint(0, 256, (5, 7, 3)).astype(
        np.uint8)
    for f16 in (False, True):
        jcfg.F16 = tcfg.F16 = f16
        np.testing.assert_array_equal(timage.mold_image(img, tcfg),
                                      jimage.mold_image(img, jcfg))
        np.testing.assert_array_equal(
            timage.unmold_image(timage.mold_image(img, tcfg), tcfg),
            jimage.unmold_image(jimage.mold_image(img, jcfg), jcfg))
    got = timage._pad_centered(img, 12, 10)
    want = jimage._pad_centered(img, 12, 10)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    metas = np.stack([timage.compose_image_meta(i, (960, 1280, 3),
                                                (512, 640, 3),
                                                (16, 0, 496, 640), 0.5)
                      for i in range(3)])
    got, want = timage.parse_image_meta(metas), jimage.parse_image_meta(metas)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------------------
# encoders, adapter, synthetic data


def test_host_encoders_match_jax():
    rng = np.random.RandomState(10)
    q = rng.randn(9, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    lims = (np.array([-180, -90, -180]), np.array([180, 90, 180]))
    got, want = tenc.encode_ori(q, 6, 6.0, *lims), jenc.encode_ori(q, 6, 6.0,
                                                                   *lims)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    locs = np.stack([rng.uniform(-.4, .4, 9), rng.uniform(-.3, .3, 9),
                     rng.uniform(5, 40, 9)], 1)
    mn, mx = np.array([-1, -.75, 5.0]), np.array([1, .75, 40.0])
    got, want = tenc.encode_loc(locs, 4, 6.0, mn, mx), \
        jenc.encode_loc(locs, 4, 6.0, mn, mx)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    g, w = tenc.build_loc_grid(4, 6.0, mn, mx), jenc.build_loc_grid(4, 6.0,
                                                                     mn, mx)
    np.testing.assert_array_equal(g.map3d, w.map3d)
    assert g.var == w.var and g.nr_bins_per_dim == w.nr_bins_per_dim
    np.testing.assert_array_equal(MEAN_PIXEL, np.array([45, 49, 52]))
    np.testing.assert_allclose(encode_as_keypoints(q, locs, 3.0),
                               jax_keypoints(q, locs, 3.0), atol=1e-6)


def _adapters(d, subset, **overrides):
    jcfg, tcfg = small_configs(**overrides)
    jds, tds = JaxUrso(), Urso()
    jds.load_dataset(d, jcfg, subset)
    tds.load_dataset(d, tcfg, subset)
    return jds, tds


@pytest.mark.parametrize('classify', [False, True])
def test_urso_adapter_matches_jax(jax_dir, classify):
    """Field by field on a JAX-written dir: regression (the flagship's
    location) and classification of both location and orientation."""
    kw = dict(REGRESS_LOC=not classify, REGRESS_ORI=False, LOC_BINS_PER_DIM=4)
    for subset in ('train', 'val', 'test'):
        jds, tds = _adapters(jax_dir, subset, **kw)
        assert tds.name == jds.name == 'Urso'
        np.testing.assert_array_equal(tds.image_ids, jds.image_ids)
        np.testing.assert_array_equal(tds.camera.K, jds.camera.K)
        np.testing.assert_array_equal(tds.ori_histogram_map,
                                      jds.ori_histogram_map)
        np.testing.assert_array_equal(tds.ori_output_mask,
                                      jds.ori_output_mask)
        if classify:
            np.testing.assert_array_equal(tds.histogram_3D_map,
                                          jds.histogram_3D_map)
        for ti, ji in zip(tds.image_info, jds.image_info):
            assert ti['path'] == ji['path'] and ti['id'] == ji['id']
            for k in ('location', 'quaternion', 'pyr', 'angleaxis',
                      'ori_map') + (('location_map',) if classify else ()):
                np.testing.assert_allclose(np.asarray(ti[k], np.float64),
                                           np.asarray(ji[k], np.float64),
                                           rtol=0, atol=1e-6, err_msg=k)
            for a, b in zip(ti['keypoints'], ji['keypoints']):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert (np.stack([i['quaternion'] for i in tds.image_info])[:, 3]
                >= 0).all()
    for i in tds.image_ids:
        with Image.open(tds.image_info[i]['path']) as im:
            np.testing.assert_array_equal(tds.load_image(i), np.asarray(im))


def test_synthetic_dir_reads_the_same_in_jax(jax_dir, port_dir):
    """The JAX adapter reads the port's dir with the labels of the JAX
    generator's dir from the same seed; the CSVs are the same bytes."""
    for subset in ('train', 'val', 'test'):
        for name in (f'{subset}_images.csv', f'{subset}_poses_gt.csv'):
            with open(os.path.join(port_dir, name), 'rb') as f, \
                    open(os.path.join(jax_dir, name), 'rb') as g:
                assert f.read() == g.read(), name
        jcfg, _ = small_configs()
        a, b = JaxUrso(), JaxUrso()
        a.load_dataset(port_dir, jcfg, subset)
        b.load_dataset(jax_dir, jcfg, subset)
        for x, y in zip(a.image_info, b.image_info):
            for k in ('location', 'quaternion', 'pyr', 'angleaxis',
                      'ori_map'):
                np.testing.assert_array_equal(x[k], y[k])
        for i in a.image_ids:
            frame = a.load_image(i)     # PIL reads the port's PNG
            assert frame.shape == (FRAME_H, FRAME_W, 3)


def test_synthetic_body_covers_its_projected_vertices(tmp_path):
    """Every projected body vertex inside the frame is painted (the
    background's colours never reach 90 in red and green at once)."""
    make_urso_dataset(str(tmp_path), subsets=('train',), n_per_subset=6,
                      width=160, height=120, seed=3)
    qs, locs = _random_poses(np.random.RandomState(3), 6)
    K = render_intrinsics(160, 120)
    from ursonet_torch.data.synthetic import _CUBE
    body = np.concatenate([_CUBE * 1.5, [[0, 0, 3.0], [0, 2.4, 0]]])
    seen = 0
    for i in range(6):
        img = load_image_rgb(str(tmp_path / f'{i}_rgb.png'))
        uv = project(body @ se3.quat2SO3(qs[i]).T + locs[i], K)
        for x, y in uv:
            if 0 <= x < 160 and 0 <= y < 120:
                seen += 1
                assert img[y, x].max() >= 80, (i, x, y, img[y, x])
    assert seen >= 30


# --------------------------------------------------------------------------
# loader


def test_data_generator_matches_jax(jax_dir):
    """The first 6 raw batches: the same ids (RandomState shuffle), the
    same pixels (resized from 96×72 to 64×64 by 2/3), meta and poses.
    The JAX generator takes its Python path (NATIVE_LOADER off)."""
    jcfg, tcfg = small_configs(NATIVE_LOADER=False, IMAGES_PER_GPU=3)
    jds, tds = _adapters(jax_dir, 'train')
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


def test_data_generator_refuses_what_is_not_ported(jax_dir):
    _, tcfg = small_configs()
    _, tds = _adapters(jax_dir, 'train')
    with pytest.raises(NotImplementedError, match='host-parity'):
        tloader.data_generator(tds, tcfg, raw=False)
    tcfg.AUGMENT_ON_DEVICE = False
    with pytest.raises(NotImplementedError, match='host-parity'):
        tloader.data_generator(tds, tcfg)
    with pytest.raises(NotImplementedError, match='parallel'):
        tloader.data_generator(tds, small_configs()[1], batch_slice=(0, 1))


def test_data_generator_skips_five_bad_frames_then_raises(jax_dir, tmp_path):
    _, tcfg = small_configs(NATIVE_LOADER=False)
    _, tds = _adapters(jax_dir, 'train')
    good = list(tds.image_info)
    tds.image_info = [dict(i, path=str(tmp_path / 'missing.png'))
                      if n < 3 else i for n, i in enumerate(good)]
    batch = next(tloader.data_generator(tds, tcfg, shuffle=False,
                                        batch_size=2, seed=0))
    np.testing.assert_array_equal(batch['image_meta'][:, 0], [3, 4])
    tds.image_info = [dict(i, path=str(tmp_path / 'missing.png'))
                      for i in good]
    with pytest.raises(FileNotFoundError):
        next(tloader.data_generator(tds, tcfg, batch_size=2, seed=0))


def test_prefetcher_yields_in_order_and_reraises():
    def gen():
        yield from range(5)
        raise KeyError('boom')
    p = tloader.Prefetcher(gen(), depth=2)
    assert [next(p) for _ in range(5)] == list(range(5))
    for _ in range(2):
        with pytest.raises(KeyError):
            next(p)
    assert list(tloader.Prefetcher(iter([1, 2]))) == [1, 2]


def test_prefetcher_close_stops_the_thread_and_the_generator():
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)
    p = tloader.Prefetcher(endless(), depth=2)
    assert [next(p) for _ in range(3)] == [0, 1, 2]
    p.close(timeout=10)
    assert not p._thread.is_alive() and closed == [True]


def test_use_resident_follows_the_knobs(jax_dir):
    """As tests/test_engine.py::test_use_resident_knobs for the JAX
    package, and the same answers as its use_resident."""
    jcfg, tcfg = small_configs()
    jds, tds = _adapters(jax_dir, 'train')
    cases = [dict(), dict(DATA_ON_DEVICE=False),
             dict(DATA_ON_DEVICE='auto', DATA_ON_DEVICE_MAX_MB=0),
             dict(DATA_ON_DEVICE=True, AUGMENT_ON_DEVICE=False),
             dict(DATA_ON_DEVICE=True)]
    got = []
    for case in cases:
        for cfg in (jcfg, tcfg):
            cfg.DATA_ON_DEVICE, cfg.DATA_ON_DEVICE_MAX_MB = 'auto', 1024
            cfg.AUGMENT_ON_DEVICE = True
            for k, v in case.items():
                setattr(cfg, k, v)
        got.append(tloader.use_resident(tds, tcfg))
        assert got[-1] == jloader.use_resident(jds, jcfg), case
    assert got == [True, False, False, False, True]
    assert tloader.resident_bytes(tds, tcfg) == \
        jloader.resident_bytes(jds, jcfg) == 8 * (64 * 64 * 3 + 12 * 4 + 28)


def test_load_dataset_resident_stacks_the_raw_samples(jax_dir):
    jcfg, tcfg = small_configs(NATIVE_LOADER=False)
    jds, tds = _adapters(jax_dir, 'val')
    data, n = tloader.load_dataset_resident(tds, tcfg, 'cpu')
    want, m = jloader.load_dataset_resident(jds, jcfg)
    assert n == m == 8 and data.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(data[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# config files


def test_config_files_read_back_in_the_other_package(tmp_path):
    jcfg, tcfg = small_configs(STEPS_PER_EPOCH=7, CHECKPOINT_KEEP=2,
                               DATA_ON_DEVICE=False, LOG_EVERY_STEPS=3)
    tcfg.write_to_file(str(tmp_path / 'port.json'))
    jcfg.write_to_file(str(tmp_path / 'jax.json'))
    with open(tmp_path / 'port.json') as f:
        from_port = JaxConfig.from_dict(json.load(f))
    with open(tmp_path / 'jax.json') as f:
        from_jax = Config.from_dict(json.load(f))
    shared = set(tcfg.to_dict()) & set(jcfg.to_dict())
    for key in ('STEPS_PER_EPOCH', 'VALIDATION_STEPS', 'AUGMENT_ON_DEVICE',
                'NATIVE_LOADER', 'DATA_ON_DEVICE', 'DATA_ON_DEVICE_MAX_MB',
                'LOG_EVERY_STEPS', 'CHECKPOINT_FORMAT', 'CHECKPOINT_KEEP',
                'BACKBONE', 'BATCH_SIZE', 'LOSS_WEIGHTS'):
        assert key in shared, key
    for key in shared:
        assert getattr(from_port, key) == getattr(tcfg, key), key
        assert getattr(from_jax, key) == getattr(jcfg, key), key
    np.testing.assert_array_equal(from_jax.IMAGE_SHAPE, jcfg.IMAGE_SHAPE)
    assert 'MEAN_PIXEL' not in tcfg.to_dict()
