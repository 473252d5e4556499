"""The port's warp (ursonet_torch/ops/warp_cuda.py on CPU tensors, i.e. the
plain PyTorch versions in ops/augment.py) against the JAX package's gather
references and its Pallas kernel in interpreter mode.

Tolerances: bilinear max abs diff ≤ 1e-3 on [0,255] data (f32 rounding
of the coordinates); nearest may differ only where a source coordinate
sits on a .5 rounding tie, on ≤ 1e-3 of the pixels. Against the Pallas
kernel the bounds of tests/test_warp_pallas.py hold, since that kernel
rounds its source tile to bf16 and its ties upwards.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import torch

from ursonet_tpu.ops import augment as jaug
from ursonet_tpu.ops import warp_pallas as wp
from ursonet_torch import se3
from ursonet_torch.ops import augment as taug
from ursonet_torch.ops.warp_cuda import launches, warp_cuda, warp_cuda_gray

torch.set_num_threads(1)


def _homographies(n, seed=0):
    """Half camera rotations of ±10° per axis, half ±85° rolls."""
    rng = np.random.RandomState(seed)
    K = np.array([[640.0, 0, 320], [0, 640.0, 256], [0, 0, 1]])
    Ms = []
    for i in range(n):
        if i % 2 == 0:
            pyr = (rng.rand(3) - 0.5) * 20
        else:
            pyr = np.array([0, 0, (rng.rand() - 0.5) * 170])
        Ms.append(K @ se3.euler2SO3_left(*pyr) @ np.linalg.inv(K))
    return np.stack(Ms).astype(np.float32)


def _check(interp, got, ref):
    diff = np.abs(got - ref)
    if interp == 'bilinear':
        assert diff.max() <= 1e-3
    else:
        assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize('gray', [False, True])
@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
def test_plain_warp_matches_jax_reference(interp, gray):
    rng = np.random.RandomState(3)
    imgs = (rng.rand(2, 512, 640, 3) * 255).astype(np.float32)
    if gray:
        imgs[..., 1] = imgs[..., 2] = imgs[..., 0]
    Ms = _homographies(2)
    ref_fn = jaug.warp_nearest_jax if interp == 'nearest' \
        else jaug.warp_bilinear_jax
    ref = np.asarray(ref_fn(jnp.asarray(imgs), jnp.asarray(Ms)))
    fn = warp_cuda_gray if gray else warp_cuda
    before = launches['warp_homography']
    got = fn(torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()),
             torch.from_numpy(Ms), interp)
    assert launches['warp_homography'] == before   # CPU: no kernel launch
    assert got.shape == (2, 3, 512, 640)
    _check(interp, got.numpy().transpose(0, 2, 3, 1), ref)


@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
def test_plain_warp_matches_pallas_interpret(interp):
    rng = np.random.RandomState(4)
    h, w = wp.SY + 16, wp.SX          # smallest shape the kernel tiles
    assert wp.supported(h, w)
    imgs = (rng.rand(2, h, w, 1) * 255).astype(np.float32)
    Ms = _homographies(2, seed=5)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(wp.warp_pallas(jnp.asarray(imgs), jnp.asarray(Ms),
                                        interp))
    got = taug.warp_nearest_torch if interp == 'nearest' \
        else taug.warp_bilinear_torch
    got = got(torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()),
              torch.from_numpy(Ms)).numpy().transpose(0, 2, 3, 1)
    diff = np.abs(ref - got)
    if interp == 'bilinear':
        assert diff.max() < 1.0
    else:
        assert (diff > 1.0).mean() < 1e-3


def test_plain_warp_odd_shape_and_identity():
    """Any H×W works (no tiling limit); the identity homography copies."""
    rng = np.random.RandomState(6)
    imgs = torch.from_numpy((rng.rand(3, 2, 37, 53) * 255).astype(np.float32))
    eye = torch.eye(3).expand(3, 3, 3).contiguous()
    for interp in ('nearest', 'bilinear'):
        np.testing.assert_array_equal(warp_cuda(imgs, eye, interp).numpy(),
                                      imgs.numpy())
    Ms = _homographies(3, seed=7)
    ref = np.asarray(jaug.warp_bilinear_jax(
        jnp.asarray(imgs.numpy().transpose(0, 2, 3, 1)), jnp.asarray(Ms)))
    got = warp_cuda(imgs, torch.from_numpy(Ms), 'bilinear').numpy()
    assert np.abs(got.transpose(0, 2, 3, 1) - ref).max() <= 1e-3


def test_warp_wrapper_rejects_bad_input():
    imgs = torch.zeros(2, 3, 8, 8)
    with pytest.raises(ValueError):
        warp_cuda(imgs, torch.eye(3).expand(2, 3, 3), 'cubic')
