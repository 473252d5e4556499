"""The port's SPEED adapter and synthetic SPEED generator
(`ursonet_torch/data/speed.py`, `data/synthetic.py::make_speed_dataset`)
against the JAX package's, on datasets written by each package.

Tolerances: paths (relative to the dataset dir), locations, quaternions,
Euler angles, angle-axis vectors, keypoints, the bin maps and masks
exactly; PMFs within 1e-6; the JSON annotations byte for byte. The
frames differ (the port draws the body with its own rasterizer, the JAX
package with cv2): their mean absolute difference is measured at
2.3-4.0 gray levels on 320x200 frames and held under MEAN_ABS_FRAME.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from ursonet_tpu.data import speed as jspeed
from ursonet_tpu.data.synthetic import make_speed_dataset as jmake
from ursonet_torch.data import speed as tspeed
from ursonet_torch.data.synthetic import make_speed_dataset as tmake
from torch_parity import small_configs

SUBSETS = ('train_no_val', 'val', 'test', 'real_test')
MEAN_ABS_FRAME = 8.0


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('speed')
    out = {}
    for side, make in (('jax', jmake), ('port', tmake)):
        out[side] = str(root / side)
        make(out[side], n_per_subset={'train_no_val': 6, 'val': 3,
                                      'test': 3, 'real_test': 2}, seed=3)
    return out


@pytest.mark.parametrize('seed', [0, 3])
def test_make_speed_dataset_writes_jaxs_annotations(tmp_path, seed):
    jmake(str(tmp_path / 'j'), n_per_subset=3, seed=seed)
    tmake(str(tmp_path / 't'), n_per_subset=3, seed=seed)
    for subset in SUBSETS:
        with open(tmp_path / 'j' / f'{subset}.json', 'rb') as f:
            want = f.read()
        with open(tmp_path / 't' / f'{subset}.json', 'rb') as f:
            assert f.read() == want, subset
    assert sorted(os.listdir(tmp_path / 'j' / 'images')) == \
        sorted(os.listdir(tmp_path / 't' / 'images')) == \
        ['real_test', 'test', 'train']


def _same_info(a, b, root_a, root_b):
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if k == 'path':
            assert os.path.relpath(va, root_a) == os.path.relpath(vb, root_b)
        elif k == 'keypoints':
            for x, y in zip(va, vb):
                np.testing.assert_array_equal(x, y)
        elif k == 'ori_map':
            np.testing.assert_allclose(vb, va, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(vb), np.asarray(va),
                                          err_msg=k)


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('subset', SUBSETS)
@pytest.mark.parametrize('regress_ori', [False, True])
def test_adapter_matches_jax(dirs, writer, subset, regress_ori):
    jcfg, tcfg = small_configs(REGRESS_ORI=regress_ori, ORI_BINS_PER_DIM=8)
    d = dirs[writer]
    want, got = jspeed.Speed(), tspeed.Speed()
    want.load_dataset(d, jcfg, subset)
    got.load_dataset(d, tcfg, subset)
    assert got.name == want.name == 'Speed'
    assert got.num_images == want.num_images
    np.testing.assert_array_equal(got.image_ids, want.image_ids)
    for a, b in zip(want.image_info, got.image_info):
        _same_info(a, b, d, d)
    for attr in ('ori_histogram_map', 'ori_output_mask'):
        if getattr(want, attr) is None:
            assert getattr(got, attr) is None
        else:
            np.testing.assert_array_equal(getattr(got, attr),
                                          getattr(want, attr))
    if subset in tspeed.UNLABELED:
        assert not got.ori_output_mask.any()


def test_camera_and_quaternion_convention():
    np.testing.assert_array_equal(tspeed.Camera.K, jspeed.Camera.K)
    assert (tspeed.Camera.width, tspeed.Camera.height) == (1920, 1200)
    rng = np.random.RandomState(0)
    for _ in range(20):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        np.testing.assert_array_equal(tspeed.quat_scalar_last(q),
                                      jspeed._quat_scalar_last(q))
        assert tspeed.quat_scalar_last(q)[3] >= 0
    assert tspeed.SUBSETS == jspeed.SUBSETS
    assert tspeed.UNLABELED == jspeed.UNLABELED
    for s in tspeed.SUBSETS:
        assert tspeed._image_subdir(s) == jspeed._image_subdir(s)
    with pytest.raises(ValueError, match='subset'):
        tspeed.Speed().load_dataset('.', small_configs()[1], 'nope')


def test_frames_read_as_pil_reads_them_and_near_jaxs(dirs):
    _, tcfg = small_configs()
    diffs = []
    for subset in ('train_no_val', 'test'):
        ds = {side: tspeed.Speed() for side in dirs}
        for side, d in dirs.items():
            ds[side].load_dataset(d, tcfg, subset)
        for i in ds['port'].image_ids:
            frames = {}
            for side in dirs:
                path = ds[side].image_info[i]['path']
                pil = np.asarray(Image.open(path))
                got = ds[side].load_image(i)
                np.testing.assert_array_equal(got, np.repeat(pil[..., None],
                                                             3, 2))
                frames[side] = pil.astype(np.float64)
            diffs.append(np.abs(frames['port'] - frames['jax']).mean())
    assert max(diffs) <= MEAN_ABS_FRAME, diffs


def test_annotations_are_scalar_first(dirs):
    with open(os.path.join(dirs['port'], 'val.json')) as f:
        anns = json.load(f)
    _, tcfg = small_configs()
    ds = tspeed.Speed()
    ds.load_dataset(dirs['port'], tcfg, 'val')
    for a, info in zip(anns, ds.image_info):
        w, x, y, z = a['q_vbs2tango']
        np.testing.assert_array_equal(
            info['quaternion'], np.sign(w) * np.float32([x, y, z, w]))
        np.testing.assert_array_equal(info['location'],
                                      np.float32(a['r_Vo2To_vbs_true']))
