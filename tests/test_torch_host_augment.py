"""The host-parity generator (AUGMENT_ON_DEVICE False, `--host_augment`)
against the JAX package's: the port's numpy versions of cv2's
warpPerspective and GaussianBlur (`ursonet_torch/ops/cv_host.py`)
against cv2 itself, the per-frame augmentation functions
(`ops/augment.py`: `_warp_host`, `sim2real_host`) against the JAX
package's on the same numpy draws, and `data_generator(raw=False)`
against the JAX generator on a synthetic URSO set of 128×96 frames.

Tolerances:
  * the warp: every pixel equal to cv2's, over camera rotations and rolls
    drawn as the augmentation draws them, at 128×96 and 1280×960;
  * the blur: every value equal to cv2's where a row holds a multiple of
    8 floats (every URSO and SPEED frame, 128×96 here); at other widths
    cv2 finishes a row in scalar code that sums in another order, and
    values differ by at most BLUR_TAIL_ABS (2 float32 steps at 255; 0.2–0.7%
    of the values at widths 77, 100 and 130);
  * the per-frame augmentation: pixels equal, poses 1e-12;
  * the generator: the same ids, poses, keypoints and PMFs within 1e-6,
    pixels equal, float16 batches under F16.
"""

import numpy as np
import pytest
import torch

import cv2

from ursonet_tpu.data import loader as jloader
from ursonet_tpu.data.synthetic import make_urso_dataset as jax_make_urso
from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_tpu.ops import augment as jaug
from ursonet_torch.data import loader as tloader
from ursonet_torch.data.urso import Camera, Urso
from ursonet_torch.ops import augment as taug
from ursonet_torch.ops import cv_host
from torch_parity import small_configs

torch.set_num_threads(1)

FRAME_W, FRAME_H = 128, 96
BLUR_TAIL_ABS = 4e-5


def _intrinsics(w, h):
    K = Camera.K.copy()
    K[0] *= w / Camera.width
    K[1] *= h / Camera.height
    return K


def _homographies(rng, K, n):
    """Camera rotations and rolls, alternating, drawn as `rotate_cam` and
    `rotate_image` draw them."""
    Ms = []
    for i in range(n):
        if i % 2:
            pyr = np.array([0.0, 0.0, (rng.rand(1)[0] - 0.5) * 170])
        else:
            pyr = (rng.rand(3) - 0.5) * 20
        R = taug.se3.euler2SO3_left(*pyr)
        Ms.append(K @ R @ np.linalg.inv(K))
    return Ms


@pytest.mark.parametrize('wh,n', [((FRAME_W, FRAME_H), 200),
                                  ((1280, 960), 6)])
def test_warp_matches_cv2(wh, n):
    w, h = wh
    rng = np.random.RandomState(w)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for M in _homographies(rng, _intrinsics(w, h), n):
        want = cv2.warpPerspective(img, M, (w, h),
                                   flags=cv2.WARP_INVERSE_MAP)
        np.testing.assert_array_equal(
            cv_host.warp_perspective_inverse(img, M), want)
    # a gray plane, and a homography that sends part of the frame to
    # infinity (a zero denominator inside the image)
    M = np.array([[1.0, 0.1, 3.0], [0.05, 1.0, -2.0], [0.01, -0.02, 0.2]])
    gray = img[..., 0].copy()
    np.testing.assert_array_equal(
        cv_host.warp_perspective_inverse(gray, M),
        cv2.warpPerspective(gray, M, (w, h), flags=cv2.WARP_INVERSE_MAP))


@pytest.mark.parametrize('hw,n', [((FRAME_H, FRAME_W), 60), ((960, 1280), 2)])
def test_blur_matches_cv2(hw, n):
    rng = np.random.RandomState(hw[1])
    img = (rng.rand(*hw, 3) * 255).astype(np.float32)
    sigmas = np.concatenate([[1e-3, 0.0625, 0.1875, 1.5],
                             rng.uniform(0, 1.5, n)])
    for sigma in sigmas:
        want = cv2.GaussianBlur(img, (0, 0), sigma)
        got = cv_host.gaussian_blur(img, sigma)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=str(sigma))


@pytest.mark.parametrize('w', [77, 100, 130])
def test_blur_ragged_widths_within_tail_bound(w):
    rng = np.random.RandomState(w)
    img = (rng.rand(50, w, 3) * 255).astype(np.float32)
    for sigma in rng.uniform(0, 1.5, 20):
        d = np.abs(cv_host.gaussian_blur(img, sigma)
                   - cv2.GaussianBlur(img, (0, 0), sigma))
        assert d.max() <= BLUR_TAIL_ABS, (sigma, d.max())


def test_kernel_matches_cv2():
    for sigma in np.linspace(0.01, 1.5, 150):
        n = int(np.rint(sigma * 8 + 1)) | 1
        want = cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel()
        np.testing.assert_array_equal(cv_host.gaussian_kernel(sigma), want)


# --------------------------------------------------------------------------
# the per-frame augmentation


def test_warp_host_matches_jax():
    rng = np.random.RandomState(3)
    K = Camera.K
    img = rng.randint(0, 256, (FRAME_H, FRAME_W, 3)).astype(np.uint8)
    for i in range(20):
        t = rng.uniform(-5, 5, 3) + [0, 0, 20]
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        seed = 100 + i
        if i % 2:
            want = jaug.rotate_image(img, t, q, K, np.random.RandomState(seed))
            got = taug.rotate_image(img, t, q, K, np.random.RandomState(seed))
        else:
            want = jaug.rotate_cam(img, t, q, K, 20,
                                   np.random.RandomState(seed))
            got = taug.rotate_cam(img, t, q, K, 20,
                                  np.random.RandomState(seed))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-12)


def test_sim2real_host_matches_jax():
    """Many frames through one shared stream: every draw of every op
    (the dice, the order, noise, sigma, offsets, gains and the dropout's
    mask) must match for the pixels and the stream to stay together."""
    rng = np.random.RandomState(4)
    jr, tr = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(40):
        img = rng.randint(0, 256, (FRAME_H, FRAME_W, 3)).astype(np.uint8)
        np.testing.assert_array_equal(taug.sim2real_host(img, tr),
                                      jaug.sim2real_host(img, jr))
    assert tr.randint(1 << 30) == jr.randint(1 << 30)


# --------------------------------------------------------------------------
# the generator


@pytest.fixture(scope='module')
def urso_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso_host'))
    jax_make_urso(d, n_per_subset=8, width=FRAME_W, height=FRAME_H)
    return d


CASES = {
    # quaternion regression, every augmentation
    'quaternion': dict(REGRESS_ORI=True, ROT_AUG=True, ROT_IMAGE_AUG=True,
                       SIM2REAL_AUG=True),
    # orientation soft-classification (PMFs re-encoded after a rotation)
    # in F16
    'classification': dict(ROT_AUG=True, ROT_IMAGE_AUG=True,
                           SIM2REAL_AUG=True, F16=True),
    # keypoints (recomputed from the rotated pose at scale 1)
    'keypoints': dict(REGRESS_KEYPOINTS=True, ROT_AUG=True,
                      ROT_IMAGE_AUG=True, SIM2REAL_AUG=True),
    # no augmentation: the resize and the mold alone
    'plain': dict(ROT_AUG=False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_generator_matches_jax(urso_dir, case):
    jcfg, tcfg = small_configs(AUGMENT_ON_DEVICE=False, NATIVE_LOADER=False,
                               **CASES[case])
    jds, tds = JaxUrso(), Urso()
    jds.load_dataset(urso_dir, jcfg, 'train')
    tds.load_dataset(urso_dir, tcfg, 'train')
    jgen = jloader.data_generator(jds, jcfg, shuffle=True, batch_size=3,
                                  seed=11)
    tgen = tloader.data_generator(tds, tcfg, shuffle=True, batch_size=3,
                                  seed=11)
    dtype = np.float16 if tcfg.F16 else np.float32
    for _ in range(4):       # 12 samples: more than one pass of 8
        want, got = next(jgen), next(tgen)
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got['image_meta'],
                                      want['image_meta'])
        assert got['images'].dtype == dtype
        np.testing.assert_array_equal(got['images'], want['images'])
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            if k.startswith('gt_'):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-6, err_msg=k)


def test_generator_restarts_its_stream(urso_dir):
    """A new generator starts both streams afresh (the engine makes one a
    train() call, as the JAX engine does)."""
    _, tcfg = small_configs(AUGMENT_ON_DEVICE=False, ROT_AUG=True,
                            ROT_IMAGE_AUG=True)
    tds = Urso()
    tds.load_dataset(urso_dir, tcfg, 'train')
    a = tloader.data_generator(tds, tcfg, batch_size=2, seed=3)
    first = next(a)
    next(a)
    b = tloader.data_generator(tds, tcfg, batch_size=2, seed=3)
    again = next(b)
    for k in first:
        np.testing.assert_array_equal(again[k], first[k])


def test_molded_batch_reaches_the_step_as_nchw(urso_dir):
    _, tcfg = small_configs(AUGMENT_ON_DEVICE=False, F16=True)
    tds = Urso()
    tds.load_dataset(urso_dir, tcfg, 'train')
    batch = next(tloader.data_generator(tds, tcfg, batch_size=2, seed=0))
    mb = tloader.molded_to_device(batch, torch.device('cpu'))
    assert mb['images'].dtype == torch.float16
    assert mb['images'].is_contiguous()
    np.testing.assert_array_equal(mb['images'].numpy(),
                                  batch['images'].transpose(0, 3, 1, 2))
    assert mb['gt_ori'].dtype == torch.float32
