"""The port's rotation augmentation, device preprocess, SE(3) math and
orientation encoder against the JAX package on the same inputs.

The JAX side draws its randomness from a PRNG key; the tests replay that
key's splits with jax.random and feed the resulting draws to the port's
deterministic apply step. Tolerances: images as in test_torch_warp.py
(nearest may differ on ≤ 1e-3 of the pixels, at rounding ties; bilinear
≤ 1e-3 abs), except that the bilinear images of the augmentation alone
are held at 1e-2: both packages form M = K·R·K⁻¹ in f32 and round it
differently (the homographies agree to ~1e-7 relative), which moves
source coordinates by up to ~2e-5 px, 5.4e-3 on [0,255] noise with the
small-image K used there. Locations and quaternions within 1e-5; PMFs
within 1e-6 abs; the orientation grid's mask exactly and its quaternions
within 1e-6."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ursonet_tpu import se3 as jse3
from ursonet_tpu import se3jax
from ursonet_tpu.data import loader as jloader
from ursonet_tpu.data.urso import Camera as JaxCamera
from ursonet_tpu.ops import augment as jaug
from ursonet_tpu.ops import encoders as jenc
from ursonet_torch import se3, se3t
from ursonet_torch.data import loader as tloader
from ursonet_torch.data.urso import Camera
from ursonet_torch.ops import augment as taug
from ursonet_torch.ops import encoders as tenc
from ursonet_torch.ops.image import resize_geometry
from torch_parity import small_configs, unit_quats

torch.set_num_threads(1)


def _jax_rotation_draws(key, b, magnitude=20.0):
    """The draws rotation_augment_batch makes from `key`."""
    k_dice, k_cam, k_roll = jax.random.split(key, 3)
    return {
        'dice': np.asarray(jax.random.uniform(k_dice, (b,))),
        'pyr_cam': np.asarray(
            (jax.random.uniform(k_cam, (b, 3)) - 0.5) * magnitude),
        'roll': np.asarray((jax.random.uniform(k_roll, (b, 1)) - 0.5) * 170.0),
    }


def _to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _check_images(interp, got_nchw, ref_nhwc, bilinear_tol=1e-3):
    diff = np.abs(got_nchw.numpy().transpose(0, 2, 3, 1) - np.asarray(ref_nhwc))
    if interp == 'bilinear':
        assert diff.max() <= bilinear_tol
    else:
        assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize('rot_aug,rot_image_aug,interp', [
    (True, True, 'nearest'), (True, False, 'bilinear'),
    (False, True, 'nearest')])
def test_rotation_augment_apply_matches_jax(rot_aug, rot_image_aug, interp):
    rng = np.random.RandomState(0)
    b, h, w = 8, 64, 96
    imgs = (rng.rand(b, h, w, 3) * 255).astype(np.float32)
    locs = np.stack([rng.uniform(5, 40, b), rng.uniform(-3, 3, b),
                     rng.uniform(-3, 3, b)], 1).astype(np.float32)
    quats = unit_quats(rng, b)
    K = np.array([[48.0, 0, 48], [0, -40.0, 32], [0, 0, 1]], np.float32)
    key = jax.random.PRNGKey(11)
    ref = jaug.rotation_augment_batch(
        key, jnp.asarray(imgs), jnp.asarray(locs), jnp.asarray(quats),
        jnp.asarray(K), 20.0, rot_aug, rot_image_aug, interp,
        use_pallas=False)
    draws = _jax_rotation_draws(key, b)
    assert (draws['dice'] > 0.5).any() and (draws['dice'] <= 0.5).any()
    got = taug.rotation_augment_apply(
        torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(locs), torch.from_numpy(quats), torch.from_numpy(K),
        _to_torch(draws), rot_aug, rot_image_aug, interp)
    _check_images(interp, got[0], ref[0], bilinear_tol=1e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-5, atol=1e-5)


def test_se3_matches_jax_and_numpy():
    """Batched tensor SE(3) math against se3jax and the numpy module, and
    the port's numpy copies against the JAX package's."""
    rng = np.random.RandomState(9)
    pyr = (rng.rand(64, 3) - 0.5) * np.array([360, 180, 360])
    pyr[:8, 1] = 90.0                       # yaw at the gimbal pole
    pyr = pyr.astype(np.float32)
    R = se3t.euler2SO3_left(*torch.from_numpy(pyr).T)
    np.testing.assert_allclose(
        R.numpy(), np.asarray(se3jax.euler2SO3_left(*jnp.asarray(pyr).T)),
        atol=1e-6)
    q = se3t.SO32quat(R)
    np.testing.assert_allclose(
        q.numpy(), np.asarray(se3jax.SO32quat(jnp.asarray(R.numpy()))),
        atol=1e-6)
    for i in range(0, 64, 7):
        Rn = se3.euler2SO3_left(*pyr[i].astype(np.float64))
        np.testing.assert_allclose(Rn, jse3.euler2SO3_left(
            *pyr[i].astype(np.float64)), atol=1e-12)
        np.testing.assert_allclose(se3.SO32quat(Rn), jse3.SO32quat(Rn),
                                   atol=1e-12)
        # f32 vs f64 may take another Shepperd branch: compare up to sign
        assert abs(float(np.dot(q[i].numpy(), se3.SO32quat(Rn)))) > 1 - 1e-6
    np.testing.assert_allclose(se3t.quat2SO3(q).numpy(), R.numpy(),
                               atol=1e-5)
    a, b = unit_quats(rng, 16), unit_quats(rng, 16)
    got = se3t.quat_mult(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(se3jax.quat_mult(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)
    np.testing.assert_allclose(got[3], se3.quat_mult(a[3], b[3]), atol=1e-6)
    np.testing.assert_allclose(se3.quat_mult(a[3], b[3]),
                               jse3.quat_mult(a[3], b[3]), atol=1e-12)
    np.testing.assert_allclose(se3.euler2quat(*pyr[:5].T.astype(np.float64)),
                               jse3.euler2quat(*pyr[:5].T.astype(np.float64)),
                               atol=1e-12)


def test_draw_rotation_ranges():
    g = torch.Generator().manual_seed(0)
    d = taug.draw_rotation(g, 1000, 20.0)
    assert d['dice'].shape == (1000,)
    assert float(d['pyr_cam'].abs().max()) <= 10.0
    assert float(d['roll'].abs().max()) <= 85.0
    again = taug.draw_rotation(torch.Generator().manual_seed(0), 1000, 20.0)
    assert torch.equal(d['roll'], again['roll'])


@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
def test_device_preprocess_matches_jax(interp):
    jcfg, tcfg = small_configs(mode='pad64', dim=128, ROT_AUG=True,
                               ROT_IMAGE_AUG=True, WARP_INTERPOLATION=interp,
                               IMAGES_PER_GPU=6)
    grid = jenc.build_ori_grid(jcfg.ORI_BINS_PER_DIM)
    ds = types.SimpleNamespace(camera=JaxCamera(), name='Urso',
                               ori_histogram_map=grid.quat,
                               ori_output_mask=grid.mask)
    rng = np.random.RandomState(1)
    b = jcfg.BATCH_SIZE
    h, w = int(jcfg.IMAGE_SHAPE[0]), int(jcfg.IMAGE_SHAPE[1])
    (oh, ow), window, scale = resize_geometry(
        960, 1280, tcfg.IMAGE_MIN_DIM, tcfg.IMAGE_MAX_DIM, 0, 'pad64')
    assert (oh, ow) == (h, w)
    raw = {
        'images_u8': rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        'location': np.stack([rng.uniform(5, 40, b), rng.uniform(-3, 3, b),
                              rng.uniform(-3, 3, b)], 1).astype(np.float32),
        'quaternion': unit_quats(rng, b),
        'image_meta': np.zeros((b, 12), np.float32),
    }
    key = jax.random.PRNGKey(5)
    ref = jloader.make_device_preprocess(jcfg, ds)(
        key, {k: jnp.asarray(v) for k, v in raw.items()})
    # make_device_preprocess splits its key once before the augmentation
    _, sub = jax.random.split(key)
    draws = _to_torch(_jax_rotation_draws(sub, b))
    got = tloader.make_device_preprocess(tcfg, device='cpu')(raw, draws)
    _check_images(interp, got['images'], ref['images'])
    np.testing.assert_allclose(got['gt_loc'].numpy(), np.asarray(ref['gt_loc']),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got['gt_ori'].numpy(), np.asarray(ref['gt_ori']),
                               rtol=0, atol=1e-6)
    assert got['images'].shape == (b, 3, h, w)


def test_preprocess_without_augmentation_and_unported_modes():
    _, tcfg = small_configs(ROT_AUG=False, ROT_IMAGE_AUG=False)
    pre = tloader.make_device_preprocess(tcfg, device='cpu')
    assert pre.draw(None, 2) is None
    raw = {'images_u8': np.full((2, 64, 64, 3), 200, np.uint8),
           'location': np.ones((2, 3), np.float32),
           'quaternion': np.tile(np.float32([0, 0, 0, 1]), (2, 1)),
           'image_meta': np.zeros((2, 12), np.float32)}
    out = pre(raw)
    np.testing.assert_allclose(out['images'][:, :, 0, 0].numpy(),
                               np.tile(200 - tcfg.MEAN_PIXEL, (2, 1)),
                               rtol=1e-6)
    for knob in ('SIM2REAL_AUG', 'REGRESS_KEYPOINTS'):
        _, cfg = small_configs(**{knob: True})
        with pytest.raises(NotImplementedError):
            tloader.make_device_preprocess(cfg, device='cpu')


def test_ori_grid_and_pmf_match_jax_at_24_bins():
    jgrid = jenc.build_ori_grid(24)
    tgrid = tenc.build_ori_grid(24)
    np.testing.assert_array_equal(tgrid.mask, jgrid.mask)
    np.testing.assert_allclose(tgrid.quat, jgrid.quat, rtol=0, atol=1e-6)
    assert tenc.ori_variance(6.0, 24) == jenc.ori_variance(6.0, 24)
    q = unit_quats(np.random.RandomState(2), 16)
    ref = np.asarray(jenc.encode_ori_pmf(
        jnp.asarray(q), jnp.asarray(jgrid.quat), jnp.asarray(jgrid.mask),
        6.0, 24, xp=jnp))
    got_t = tenc.encode_ori_pmf(torch.from_numpy(q),
                                torch.from_numpy(tgrid.quat),
                                torch.from_numpy(tgrid.mask), 6.0, 24)
    got_np = tenc.encode_ori_pmf(q, tgrid.quat, tgrid.mask, 6.0, 24)
    np.testing.assert_allclose(got_t.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_np, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_t.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_camera_and_resize_geometry():
    np.testing.assert_array_equal(Camera.K, JaxCamera.K)
    assert Camera.fy < 0
    from ursonet_tpu.ops import image as jimage
    for mode, lo, hi in [('pad64', 512, 640), ('square', 128, 128),
                         ('none', None, None), ('crop', 256, None)]:
        probe = np.zeros((960, 1280, 3), np.uint8)
        img, window, scale, _, _ = jimage.resize_image(
            probe, min_dim=lo, max_dim=hi, min_scale=0, mode=mode)
        out, w2, s2 = resize_geometry(960, 1280, lo, hi, 0, mode)
        assert out == img.shape[:2]
        assert tuple(w2) == tuple(window) and s2 == scale
