"""Tests of the port that need the card (marked `cuda`; they skip
without one). This file imports nothing of JAX, so it also runs on a
machine with only PyTorch, where tests/conftest.py (which imports JAX)
is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ursonet_torch.ops import augment
from ursonet_torch.ops import warp_cuda as wc
from torch_parity import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _inputs(dev, b, c, h, w, seed):
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(
        (rng.rand(b, c, h, w) * 255).astype(np.float32)).to(dev)
    K = chip_smoke.net_intrinsics(chip_smoke.flagship_config())
    Ms = torch.from_numpy(chip_smoke.homographies(b, K, rng)).to(dev)
    return imgs, Ms


@pytest.mark.parametrize('shape', [(4, 3, 512, 640), (3, 3, 100, 130)])
@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
def test_kernel_matches_plain(cuda_device, interp, shape):
    """Bit-identical source coordinates, so nearest agrees exactly and
    bilinear to f32 rounding."""
    imgs, Ms = _inputs(cuda_device, *shape, seed=1)
    plain = augment.warp_nearest_torch if interp == 'nearest' \
        else augment.warp_bilinear_torch
    before = wc.launches['warp_homography']
    got = wc.warp_cuda(imgs, Ms, interp)
    gray = wc.warp_cuda_gray(imgs, Ms, interp)
    torch.cuda.synchronize()
    assert wc.launches['warp_homography'] == before + 2
    ref = plain(imgs, Ms)
    ref_gray = plain(imgs[:, :1].contiguous(), Ms).expand_as(imgs)
    tol = 0.0 if interp == 'nearest' else 1e-3
    assert (got - ref).abs().max().item() <= tol
    assert (gray - ref_gray).abs().max().item() <= tol


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    imgs, Ms = _inputs(cuda_device, 2, 3, 32, 48, seed=2)
    with pytest.raises(ValueError):
        wc.warp_cuda(imgs.permute(0, 1, 3, 2), Ms)          # not contiguous
    with pytest.raises(ValueError):
        wc.warp_cuda(imgs.double(), Ms)
    with pytest.raises(ValueError):
        wc.warp_cuda(imgs, Ms.cpu())


def test_small_main_path_launches_the_kernel(cuda_device):
    wc.reset_counts()
    res = chip_smoke.run_main_path(chip_smoke.small_config(), cuda_device,
                                   seed=0, steps=3)
    chip_smoke.check_main_path(res)
    assert wc.launches['warp_homography'] == 3 + 1   # 3 train + 1 validation
