"""`test --video` in the port: the RGB JPEG encoder and the standard
Huffman tables of MJPEG frames (`data/jpeg.py`), the AVI reader and
writer (`data/avi.py`), `video.detect_video` and its overlay, and the
CLI, against cv2 and the JAX package (`ursonet_tpu/video.py`) on the
CPU.

Bounds, measured on these frames (synthetic URSO renders, 128 x 96):
  * cv2.imdecode (libjpeg) and PIL decode the port's RGB JPEGs to the
    port decoder's pixels bit for bit; the round trip is within 3 levels
    of the frame on average (quality 75, 4:2:0);
  * cv2's VideoCapture decodes MJPEG through FFmpeg, whose IDCT and
    chroma upsampling are not libjpeg's: its frames and the port's
    differ by up to 62 levels on a pixel (at the wireframe's sharp
    coloured edges) and 0.77 on average (measured), held at 64 and 1.0,
    on the port's clip and on one cv2 wrote;
  * detect_video's poses equal the JAX model's (the port's weights) and
    `decode_results` on the same decoded frames within 1e-4 (the
    forwards sum in other orders);
  * the overlay's endpoints are `_overlay_axes`'s exactly.
"""

import io
import os
import shutil

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import ursonet_tpu.evaluate as jeval
from ursonet_tpu import video as jvideo
from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.ops import image as jimage
from ursonet_torch import pose_estimator as tcli
from ursonet_torch import video as tvideo
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.data.avi import AviReader, AviWriter
from ursonet_torch.data.jpeg import decode_jpeg, encode_jpeg
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.engine import UrsoNet
from torch_parity import small_configs, unit_quats

torch.set_num_threads(2)

N_FRAMES = 5
FPS = 12.5


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    """A synthetic URSO test set and an AVI of its frames, written by the
    port and by cv2."""
    root = tmp_path_factory.mktemp('video')
    ds_dir = root / 'datasets' / 'tiny'
    make_urso_dataset(str(ds_dir), subsets=('test',),
                      n_per_subset=N_FRAMES, width=128, height=96, seed=2)
    _, tcfg = small_configs()
    ds = Urso()
    ds.load_dataset(str(ds_dir), tcfg, 'test')
    frames = [ds.load_image(i) for i in ds.image_ids]
    port = str(root / 'clip.avi')
    w = AviWriter(port, FPS)
    for f in frames:
        w.append(f)
    w.close()
    other = str(root / 'cv2.avi')
    vw = cv2.VideoWriter(other, cv2.VideoWriter_fourcc(*'MJPG'), FPS,
                         (128, 96))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    yield {'root': root, 'frames': frames, 'port': port, 'cv2': other,
           'ds_dir': str(ds_dir)}
    shutil.rmtree(root, ignore_errors=True)


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return out, fps


def test_rgb_jpeg_round_trip(clip):
    for frame in clip['frames']:
        data = encode_jpeg(frame)
        got = decode_jpeg(data)
        want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                         cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(io.BytesIO(data))))
        assert np.abs(got.astype(int) - frame).mean() < 3.0


def test_encoder_writes_pils_tables_and_mjpeg_frames_decode(clip):
    """The port's RGB JPEG has the tables PIL writes at quality 75, and
    without its DHT segments (an MJPEG frame) decodes the same."""
    frame = clip['frames'][0]
    data = encode_jpeg(frame)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, 'JPEG', quality=75)

    def segments(d, keep):
        i, out = 2, []
        while d[i + 1] != 0xDA:
            n = d[i + 2] * 256 + d[i + 3]
            if d[i + 1] in keep:
                out.append(d[i + 4:i + 2 + n])
            i += 2 + n
        return b''.join(out), i

    for marker in (0xC4, 0xDB):
        assert segments(data, (marker,))[0] == \
            segments(buf.getvalue(), (marker,))[0]
    i, out = 2, bytearray(data[:2])
    while data[i + 1] != 0xDA:
        n = data[i + 2] * 256 + data[i + 3]
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + n]
        i += 2 + n
    out += data[i:]
    np.testing.assert_array_equal(decode_jpeg(bytes(out)), decode_jpeg(data))


@pytest.mark.parametrize('which', ['port', 'cv2'])
def test_clip_reads_as_cv2_reads_it(clip, which):
    """Frame count, size and fps agree; the pixels within FFmpeg's bound
    (module docstring)."""
    path = clip[which]
    want, fps = _cv2_frames(path)
    r = AviReader(path)
    got = list(r)
    r.close()
    assert len(got) == len(want) == N_FRAMES
    assert (r.width, r.height, r.frames) == (128, 96, N_FRAMES)
    assert r.fps == pytest.approx(fps) == pytest.approx(FPS)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (96, 128, 3)
        d = np.abs(a.astype(int) - b)
        assert d.max() <= 64 and d.mean() <= 1.0, (d.max(), d.mean())


def test_avi_refuses_what_it_does_not_take(clip, tmp_path):
    data = bytearray(open(clip['port'], 'rb').read())
    at = data.index(b'vidsMJPG') + 4
    data[at:at + 4] = b'XVID'
    bad = tmp_path / 'xvid.avi'
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='XVID'):
        AviReader(str(bad))
    odml = tmp_path / 'odml.avi'
    odml.write_bytes(open(clip['port'], 'rb').read()
                     + b'RIFF\x04\0\0\0AVIX')
    with pytest.raises(ValueError, match='OpenDML'):
        AviReader(str(odml))
    w = AviWriter(str(tmp_path / 'w.avi'), 25)
    w.append(clip['frames'][0])
    with pytest.raises(ValueError, match='frame of'):
        w.append(clip['frames'][0][:64])
    w.close()


def test_overlay_endpoints_are_jaxs(monkeypatch):
    rng = np.random.RandomState(3)
    K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]])
    got_lines = []
    monkeypatch.setattr(cv2, 'line', lambda img, p0, p1, c, t: got_lines
                        .append((p0, p1, c, t)))
    frame = np.zeros((96, 128, 3), np.uint8)
    for i, loc in enumerate([[20.0, 1.0, -0.5], [0.01, 3.0, 2.0],
                             [-5.0, 0.0, 0.0], [np.nan, 0.0, 1.0]]):
        q = unit_quats(rng, 1)[0].astype(np.float64)
        for conv in ('unreal', 'camera'):
            got_lines.clear()
            jvideo._overlay_axes(frame, K, np.array(loc), q, conv)
            o, ends = tvideo.overlay_endpoints(K, np.array(loc), q, conv)
            assert [(o, e, c, 2) for e, c in zip(ends, tvideo.AXIS_COLORS)] \
                == got_lines
    img = tvideo.overlay_axes(frame, K, np.array([20.0, 1.0, -0.5]),
                              unit_quats(rng, 1)[0], 'unreal')
    assert img.shape == frame.shape and img.any() and not frame.any()


@pytest.fixture(scope='module')
def detected(clip):
    """detect_video of the port's clip on the CPU (batch 2: the last batch
    padded), the poses it drew recorded."""
    _, tcfg = small_configs()
    eng = UrsoNet('inference', tcfg, str(clip['root'] / 'logs'),
                  device='cpu')
    eng.initialize()
    ds = Urso()
    ds.load_dataset(clip['ds_dir'], tcfg, 'test')
    drawn = []
    real = tvideo.overlay_axes

    def record(frame, K, loc, q, conv, scale=1.0):
        drawn.append((frame.copy(), np.array(loc), np.array(q), conv))
        return real(frame, K, loc, q, conv, scale)

    tvideo.overlay_axes = record
    try:
        timings = {}
        out = tvideo.detect_video(eng, ds, clip['port'], timings=timings)
    finally:
        tvideo.overlay_axes = real
    return eng, out, drawn, timings


def test_detect_video_poses_are_jaxs(clip, detected):
    eng, out, drawn, timings = detected
    assert out == os.path.splitext(clip['port'])[0] + '_annotated.avi'
    assert len(drawn) == N_FRAMES and timings['frames'] == N_FRAMES
    assert set(timings) == set(tvideo.TIMED) | {'frames'}
    r = AviReader(out)
    assert sum(1 for _ in r.chunks()) == N_FRAMES and r.fps == FPS
    r.close()
    # the JAX model with the port's weights on the reader's frames
    jcfg, _ = small_configs()
    tree = params_to_jax_layout(eng.model.state_dict())
    jmodel = jax_build_model(jcfg)
    jds = JaxUrso()
    jds.load_dataset(clip['ds_dir'], jcfg, 'test')
    frames = list(AviReader(clip['port']))
    for i in range(0, N_FRAMES, 2):
        batch = frames[i:i + 2]
        batch = batch + [batch[-1]] * (2 - len(batch))
        molded = np.stack([jimage.mold_image(jimage.resize_image(
            f, min_dim=jcfg.IMAGE_MIN_DIM, min_scale=jcfg.IMAGE_MIN_SCALE,
            max_dim=jcfg.IMAGE_MAX_DIM, mode=jcfg.IMAGE_RESIZE_MODE)[0]
            .astype(np.float32), jcfg) for f in batch])
        raw = jmodel.apply(tree, jnp.asarray(molded), training=False)
        locs, qs = jeval.decode_results(
            {k: np.asarray(v) for k, v in raw.items()}, jcfg, jds)
        for j in range(min(2, N_FRAMES - i)):
            frame, loc, q, conv = drawn[i + j]
            np.testing.assert_array_equal(frame, frames[i + j])
            assert conv == 'unreal'
            np.testing.assert_allclose(loc, locs[j], rtol=1e-4, atol=1e-4)
            assert abs(abs(float(np.dot(q, qs[j]))) - 1.0) < 1e-4


def test_max_frames_keeps_jaxs_check(clip, detected):
    """max_frames=3 at batch 2: the first batch flushes 2 frames, the
    third frame makes n_done + len(buf) = 3 and stops: 3 frames."""
    eng = detected[0]
    ds = Urso()
    ds.load_dataset(clip['ds_dir'], eng.config, 'test')
    out = tvideo.detect_video(eng, ds, clip['port'],
                              str(clip['root'] / 'three.avi'), max_frames=3,
                              log_fn=lambda *a: None)
    r = AviReader(out)
    assert sum(1 for _ in r.chunks()) == 3
    r.close()


@pytest.mark.parametrize('int8', [False, True], ids=['float', 'int8'])
def test_cli_test_video(clip, int8, capsys):
    out_dir = clip['root'] / ('out_int8' if int8 else 'out')
    argv = ['test', '--dataset', 'tiny',
            '--data_dir', str(clip['root'] / 'datasets'),
            '--logs', str(clip['root'] / 'logs'), '--out_dir', str(out_dir),
            '--weights', 'none', '--backbone', 'resnet50', '--bottleneck',
            '8', '--branch_size', '16', '--image_scale', '0.1',
            '--ori_resolution', '6', '--classify_ori', '--regress_loc',
            '--eval_batch', '2', '--video', clip['port']]
    if int8:
        argv += ['--int8', '--bias_correct', '0']
    assert tcli.main(argv, device='cpu') == 0
    path = out_dir / 'clip.avi_annotated.avi'
    assert f"Annotated video written to {path} ({N_FRAMES} frames)" \
        in capsys.readouterr().out
    r = AviReader(str(path))
    got = list(r)
    r.close()
    assert len(got) == N_FRAMES and got[0].shape == (96, 128, 3)
