"""The port's sim2real augmentation (`ursonet_torch/ops/augment.py`:
`draw_sim2real`, `sim2real_apply`) and the preprocess that runs it
before the gray warp, against the JAX package's `sim2real_batch` and
`make_device_preprocess` on the CPU.

The JAX side draws from a PRNG key; `_jax_sim2real_draws` replays its
splits (k_apply, k_perm, k_ops; five op keys from k_ops) and hands the
values to the port's deterministic apply. The op keys pair with the ops
as the JAX package pairs them: by position in the shared order
(op perm[i] draws from op_keys[i]), by op in the per-image order (op j
from op_keys[j]).

Tolerances: the gray conversion, noise, brightness, contrast, dropout,
clip and the apply mask bit for bit (the hash in uint32 arithmetic
exactly); the blur within 1e-4 on the 0-255 scale (its taps come from
exp, which differs in the last place; 9 taps summed left to right in
f32 as the JAX package sums them), and so the whole pipeline in both
orders; the whole preprocess (sim2real, the rotation on one channel, the
mold) within 1e-3, except that nearest sampling may pick another source
pixel at a rounding tie on at most 1e-3 of the pixels (as in
test_torch_augment.py).
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ursonet_tpu.data import loader as jloader
from ursonet_tpu.data.speed import Camera as JaxSpeedCamera
from ursonet_tpu.ops import augment as jaug
from ursonet_tpu.ops import encoders as jenc
from ursonet_torch.data import loader as tloader
from ursonet_torch.data.speed import Camera as SpeedCamera
from ursonet_torch.ops import augment as taug
from test_torch_augment import _jax_rotation_draws
from torch_parity import small_configs, unit_quats

torch.set_num_threads(1)

BLUR_TOL = 1e-4


def _jax_sim2real_draws(key, b, h, w, per_image_order):
    """The draws sim2real_batch(key, ...) makes, as the port's dict."""
    k_apply, k_perm, k_ops = jax.random.split(key, 3)
    op_keys = jax.random.split(k_ops, 5)
    if per_image_order:
        order = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, 5))(
            jax.random.split(k_perm, b)))
        op_key = {j: op_keys[j] for j in range(5)}
    else:
        order = np.asarray(jax.random.permutation(k_perm, 5))
        op_key = {int(op): op_keys[i] for i, op in enumerate(order)}
    shape = (b, 1, 1, 1)
    k1, k2, k3 = jax.random.split(op_key[4], 3)
    d = {
        'apply': jax.random.bernoulli(k_apply, shape=shape),
        'order': order,
        'noise': np.asarray(jax.random.normal(op_key[0], (b, h, w, 1)))
        .transpose(0, 3, 1, 2),
        'sigma': jax.random.uniform(op_key[1], shape) * 1.5,
        'add': jax.random.uniform(op_key[2], shape, minval=-20., maxval=20.),
        'mul': jax.random.uniform(op_key[3], shape, minval=0.5, maxval=2.0),
        'p': jnp.where(jax.random.bernoulli(k1, shape=shape), 0.03, 0.0),
        'size': jax.random.uniform(k2, shape, minval=0.02, maxval=0.1),
        'salt': jax.random.randint(k3, shape, 0, 2 ** 30),
    }
    return {k: torch.from_numpy(np.array(v) if k in ('noise', 'order')
                                else np.array(v).reshape(b))
            for k, v in d.items()}


def _images(rng, b, h, w):
    return (rng.rand(b, h, w, 3) * 255).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_hash_uniform_is_jaxs_bit_for_bit():
    rng = np.random.RandomState(0)
    cells = np.concatenate([
        np.arange(-2000, 2000), rng.randint(-2 ** 31, 2 ** 31 - 1, 4000),
        [-2 ** 31, 2 ** 31 - 1, 0]]).astype(np.int32)
    salts = rng.randint(0, 2 ** 30, cells.shape).astype(np.int32)
    want = np.asarray(jaug._hash_uniform(jnp.asarray(cells),
                                         jnp.asarray(salts)))
    got = taug.hash_uniform(torch.from_numpy(cells),
                            torch.from_numpy(salts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 1


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_each_op_matches_jax(seed):
    rng = np.random.RandomState(seed)
    b, h, w = 6, 40, 56
    x = (rng.rand(b, h, w, 1) * 300 - 20).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    d = _jax_sim2real_draws(key, b, h, w, per_image_order=True)
    ops_keys = jax.random.split(jax.random.split(key, 3)[2], 5)
    for j, (name, jop, top) in enumerate(zip(
            taug.SIM2REAL_OPS, jaug._SIM2REAL_OPS, taug._OPS)):
        want = np.asarray(jop(jnp.asarray(x), ops_keys[j], b))
        got = top(_nchw(x), d).numpy().transpose(0, 2, 3, 1)
        if name == 'blur':
            np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (d['p'] > 0).any() and (d['sigma'] > 0).all()


@pytest.mark.parametrize('per_image_order', [False, True])
@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_pipeline_matches_jax(per_image_order, seed):
    rng = np.random.RandomState(10 + seed)
    b, h, w = 5, 40, 56
    imgs = _images(rng, b, h, w)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.sim2real_batch(key, jnp.asarray(imgs),
                                          per_image_order=per_image_order))
    d = _jax_sim2real_draws(key, b, h, w, per_image_order)
    out = taug.sim2real_apply(_nchw(imgs), d)
    assert out.shape == (b, 3, h, w)
    got = out.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_TOL)
    # three equal channels; the images left alone are the exact gray
    assert (got == got[..., :1]).all()
    gray = 0.2126 * imgs[..., 0] + 0.7152 * imgs[..., 1] \
        + 0.0722 * imgs[..., 2]
    skip = ~d['apply'].numpy()
    np.testing.assert_array_equal(got[skip, ..., 0], gray[skip])
    np.testing.assert_array_equal(want[skip, ..., 0], gray[skip])
    assert got.min() >= 0 and got.max() <= 255


def test_draw_sim2real_ranges_and_determinism():
    d = taug.draw_sim2real(torch.Generator().manual_seed(0), 4000, 3, 5)
    assert d['noise'].shape == (4000, 1, 3, 5)
    assert 0.4 < float(d['apply'].float().mean()) < 0.6
    assert d['order'].shape == (5,)
    assert sorted(d['order'].tolist()) == [0, 1, 2, 3, 4]
    assert 0 <= float(d['sigma'].min()) and float(d['sigma'].max()) < 1.5
    assert -20 <= float(d['add'].min()) and float(d['add'].max()) < 20
    assert 0.5 <= float(d['mul'].min()) and float(d['mul'].max()) < 2
    assert set(d['p'].tolist()) == {0.0, float(np.float32(0.03))}
    assert 0.02 <= float(d['size'].min()) and float(d['size'].max()) < 0.1
    assert 0 <= int(d['salt'].min()) and int(d['salt'].max()) < 2 ** 30
    per = taug.draw_sim2real(torch.Generator().manual_seed(0), 64, 3, 5,
                             per_image_order=True)
    assert per['order'].shape == (64, 5)
    assert (per['order'].sort(dim=1).values == torch.arange(5)).all()
    again = taug.draw_sim2real(torch.Generator().manual_seed(0), 4000, 3, 5)
    for k in d:
        assert torch.equal(d[k], again[k]), k
    with pytest.raises(ValueError, match='draws'):
        taug.sim2real_apply(torch.zeros(4000, 3, 4, 5), d)


@pytest.mark.parametrize('interp,per_image_order', [
    ('nearest', False), ('bilinear', False), ('nearest', True)])
def test_speed_preprocess_matches_jax(interp, per_image_order):
    """sim2real, the rotation warping one channel (the gray route of the
    warp), the PMF re-encode and the mold, at SPEED's aspect with SPEED's
    camera, against the JAX package's preprocess."""
    jcfg, tcfg = small_configs(
        mode='pad64', dim=192, IMAGE_MIN_DIM=128, IMAGE_MAX_DIM=192,
        ROT_AUG=True, ROT_IMAGE_AUG=True, SIM2REAL_AUG=True,
        SIM2REAL_PER_IMAGE_ORDER=per_image_order, WARP_INTERPOLATION=interp,
        IMAGES_PER_GPU=6)
    grid = jenc.build_ori_grid(jcfg.ORI_BINS_PER_DIM)
    ds = types.SimpleNamespace(camera=JaxSpeedCamera(), name='Speed',
                               ori_histogram_map=grid.quat,
                               ori_output_mask=grid.mask)
    rng = np.random.RandomState(4)
    b = jcfg.BATCH_SIZE
    h, w = int(jcfg.IMAGE_SHAPE[0]), int(jcfg.IMAGE_SHAPE[1])
    assert (h, w) == (128, 192)
    raw = {
        'images_u8': rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        'location': np.stack([rng.uniform(-1, 1, b), rng.uniform(-1, 1, b),
                              rng.uniform(5, 30, b)], 1).astype(np.float32),
        'quaternion': unit_quats(rng, b),
        'image_meta': np.zeros((b, 12), np.float32),
    }
    key = jax.random.PRNGKey(21)
    ref = jloader.make_device_preprocess(jcfg, ds)(
        key, {k: jnp.asarray(v) for k, v in raw.items()})
    # the preprocess splits its key for sim2real, then for the rotation
    key2, sub = jax.random.split(key)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in
             _jax_rotation_draws(jax.random.split(key2)[1], b).items()}
    draws['sim2real'] = _jax_sim2real_draws(sub, b, h, w, per_image_order)
    pre = tloader.make_device_preprocess(tcfg, SpeedCamera(), 'cpu',
                                         'Speed')
    got = pre(raw, draws)
    diff = np.abs(got['images'].numpy().transpose(0, 2, 3, 1)
                  - np.asarray(ref['images']))
    if interp == 'nearest':
        assert (diff > 1e-3).mean() <= 1e-3
    else:
        assert diff.max() <= 1e-3
    # the channels stay equal up to the mean pixel (and its rounding)
    gray = got['images'] + pre.mean_pixel
    torch.testing.assert_close(gray, gray[:, :1].expand_as(gray), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got['gt_loc'].numpy(), np.asarray(ref['gt_loc']),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got['gt_ori'].numpy(), np.asarray(ref['gt_ori']),
                               rtol=0, atol=1e-6)


def test_preprocess_draws_sim2real_then_rotation():
    _, tcfg = small_configs(SIM2REAL_AUG=True, ROT_AUG=True)
    pre = tloader.make_device_preprocess(tcfg, device='cpu')
    d = pre.draw(torch.Generator().manual_seed(3), 2)
    assert set(d) == {'sim2real', 'dice', 'pyr_cam', 'roll'}
    assert d['sim2real']['noise'].shape == (2, 1, 64, 64)
    g = torch.Generator().manual_seed(3)
    first = taug.draw_sim2real(g, 2, 64, 64)
    assert torch.equal(first['noise'], d['sim2real']['noise'])
    assert torch.equal(taug.draw_rotation(g, 2)['roll'], d['roll'])
    _, tcfg = small_configs(SIM2REAL_AUG=True, ROT_AUG=False,
                            ROT_IMAGE_AUG=False)
    pre = tloader.make_device_preprocess(tcfg, device='cpu')
    assert set(pre.draw(torch.Generator(), 2)) == {'sim2real'}
    with pytest.raises(ValueError, match='draws'):
        pre({'images_u8': np.zeros((2, 64, 64, 3), np.uint8)})
