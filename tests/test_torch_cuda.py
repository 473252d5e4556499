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


# --------------------------------------------------------------------------
# int8 kernels (csrc/int8_gemm.cu, csrc/int8_conv.cu)

from ursonet_torch.ops import int8_cuda as ic  # noqa: E402

EPILOGUES = list(ic.EPILOGUES)


@pytest.mark.parametrize('epilogue', EPILOGUES)
@pytest.mark.parametrize('m,k,n', [(77, 147, 13), (300, 64, 200),
                                   (2000, 96, 64), (1500, 40, 136)])
def test_gemm_s8_matches_plain(cuda_device, m, k, n, epilogue):
    """Ragged M, K and N, every tile configuration, every epilogue:
    bit-exact."""
    rng = np.random.RandomState(m + k + n)
    a = chip_smoke.s8(rng, (m, k), cuda_device)
    b = ic.kernel_layout(rng.randint(-128, 128, (k, n)).astype(np.int8)) \
        .to(cuda_device)
    kw = chip_smoke.epilogue_args(cuda_device, rng, (m, n), k, epilogue)
    before = ic.launches['gemm_s8']
    got = ic.gemm_s8(a, b, epilogue, **kw)
    torch.cuda.synchronize()
    assert ic.launches['gemm_s8'] == before + 1
    want = ic.gemm_s8_torch(a, b, epilogue, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize('epilogue', EPILOGUES)
@pytest.mark.parametrize('geom', [
    # b, h, w, c, kh, kw, n, stride, padding
    (2, 9, 11, 3, 7, 7, 13, 2, ((3, 3), (3, 3))),
    (3, 7, 5, 32, 3, 3, 70, 1, ((1, 1), (1, 1))),
    (2, 8, 10, 48, 3, 3, 24, 2, ((0, 1), (0, 1))),
    (1, 6, 6, 20, 1, 1, 9, 2, ((0, 0), (0, 0)))])
def test_conv_s8_matches_plain(cuda_device, geom, epilogue):
    b, h, w, c, kh, kw, n, stride, padding = geom
    rng = np.random.RandomState(b * h * w + c + n)
    x = chip_smoke.s8(rng, (b, h, w, c), cuda_device)
    wt = ic.kernel_layout(rng.randint(-128, 128, (kh, kw, c, n))
                          .astype(np.int8)).to(cuda_device)
    oh, ow = ic.conv_out_hw(h, w, kh, kw, stride, padding)
    kw_ = chip_smoke.epilogue_args(cuda_device, rng, (b, oh, ow, n),
                                   kh * kw * c, epilogue)
    before = ic.launches['conv_s8']
    got = ic.conv_s8(x, wt, stride, padding, epilogue, **kw_)
    torch.cuda.synchronize()
    assert ic.launches['conv_s8'] == before + 1
    want = ic.conv_s8_torch(x, wt, stride, padding, epilogue, **kw_)
    assert got.shape == (b, oh, ow, n) and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_int8_wrappers_reject_what_they_do_not_take(cuda_device):
    rng = np.random.RandomState(0)
    a = chip_smoke.s8(rng, (64, 32), cuda_device)
    b = ic.kernel_layout(rng.randint(-128, 128, (32, 16)).astype(np.int8)) \
        .to(cuda_device)
    with pytest.raises(ValueError):
        ic.gemm_s8(a.float(), b)                          # not int8
    with pytest.raises(ValueError):
        ic.gemm_s8(a, b.contiguous())                     # row-major [K,N]
    with pytest.raises(ValueError):
        ic.gemm_s8(a.t().contiguous().t(), b)             # column-major a
    with pytest.raises(ValueError):
        ic.gemm_s8(a, b.cpu())
    with pytest.raises(ValueError):
        ic.gemm_s8(a, b, 'q8_relu')                       # no alpha, beta
    with pytest.raises(ValueError):
        ic.gemm_s8(a, b, 'bogus')
    x = chip_smoke.s8(rng, (1, 8, 8, 16), cuda_device)
    w = ic.kernel_layout(rng.randint(-128, 128, (3, 3, 16, 8))
                         .astype(np.int8)).to(cuda_device)
    with pytest.raises(ValueError):
        ic.conv_s8(x.permute(0, 3, 1, 2), w)              # NCHW
    with pytest.raises(ValueError):
        ic.conv_s8(x, w.contiguous())                     # HWIO memory
    with pytest.raises(ValueError):
        ic.conv_s8(x, w, 1, ((0, 0), (0, 0)), 'join',
                   alpha=torch.ones(8, device=cuda_device),
                   beta=torch.zeros(8, device=cuda_device))  # no res


def test_small_int8_serve_launches_both_kernels(cuda_device):
    """A small int8 serve through the engine on the card: both kernels
    launch, and the outputs equal the plain path's."""
    from ursonet_torch.engine import ServingEngine
    cfg = chip_smoke.small_serving_config()
    eng = ServingEngine(cfg, cuda_device,
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (cfg.BATCH_SIZE, 64, 64, 3)).astype(np.uint8)
    eng.quantize(list(imgs))
    ic.reset_counts()
    out = eng.predict_molded(imgs)
    torch.cuda.synchronize()
    assert ic.launches['gemm_s8'] > 0 and ic.launches['conv_s8'] > 0
    plain = eng.qmodel(imgs, plain=True)
    for k in out:
        assert torch.isfinite(out[k]).all()
        torch.testing.assert_close(out[k], plain[k], rtol=1e-6, atol=1e-6)
