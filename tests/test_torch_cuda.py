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
from ursonet_torch.probes import fused_block as fb
from ursonet_torch.probes import mma_rate as mr
from ursonet_torch.utils import staging
from torch_parity import cuda_device  # noqa: F401  (fixture)
import test_torch_warp_tiles as tile_mirror
import test_torch_im2col_plan as im2col_mirror

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
# the fused mode: warp, identity select and mold from the u8 batch or the
# gray plane (warp_cuda.warp_mold) against its plain version, the chain

MEAN = np.float32([123.7, 116.8, 103.9])
# (batch, height, width, source, camera): the flagship's u8 batch, config
# 4's gray plane at SPEED's 640x960, a ragged shape whose rows TMA cannot
# address (u8 rows of 390 bytes, f32 rows of 520), and ragged shapes whose
# rows it can (u8 rows of 336 bytes, f32 rows of 400) under a camera
# centred on them, so that their partial tiles load boxes by TMA
FUSED_CASES = {
    'flagship_rgb': (chip_smoke.FLAGSHIP_BATCH, 512, 640, 'rgb', 'urso'),
    'config4_gray': (chip_smoke.SPEED_TRAIN_SHAPE + ('gray', 'speed')),
    'odd_rgb': (3, 100, 130, 'rgb', 'urso'),
    'odd_gray': (3, 100, 130, 'gray', 'urso'),
    'ragged_tma_rgb': (3, 100, 112, 'rgb', 'ragged'),
    'ragged_tma_gray': (3, 100, 100, 'gray', 'ragged'),
}
IDENTITY = {'mixed': lambda b: torch.arange(b) % 3 == 1,
            'all': lambda b: torch.ones(b, dtype=torch.bool),
            'none': lambda b: torch.zeros(b, dtype=torch.bool)}


def _fused_inputs(dev, b, h, w, source, camera, seed):
    rng = np.random.RandomState(seed)
    if source == 'rgb':
        src = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3), np.uint8))
    else:
        src = torch.from_numpy((rng.rand(b, 1, h, w) * 255).astype(np.float32))
    K = {'speed': chip_smoke.speed_intrinsics,
         'ragged': lambda: chip_smoke.ragged_intrinsics(h, w),
         'urso': lambda: chip_smoke.net_intrinsics(
             chip_smoke.flagship_config())}[camera]()
    Ms = torch.from_numpy(chip_smoke.homographies(b, K, rng))
    return src.to(dev), Ms.to(dev)


def _fused_check(got, ref, interp):
    """Nearest: 0 differing elements; bilinear: today's bound, 1e-3."""
    if interp == 'nearest':
        assert int((got != ref).sum()) == 0
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3,
                                   equal_nan=True)


@pytest.mark.parametrize('identity', sorted(IDENTITY))
@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
@pytest.mark.parametrize('case', sorted(FUSED_CASES))
def test_fused_kernel_matches_plain_chain(cuda_device, case, interp,
                                          identity):
    b, h, w, source, camera = FUSED_CASES[case]
    src, Ms = _fused_inputs(cuda_device, b, h, w, source, camera, seed=11)
    ident = IDENTITY[identity](b).to(cuda_device)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    before = dict(wc.launches)
    got = wc.warp_mold(src, Ms, ident, MEAN, interp, stats=stats)
    torch.cuda.synchronize()
    assert wc.launches['warp_mold'] == before['warp_mold'] + 1
    assert wc.launches['warp_homography'] == before['warp_homography'] + 1
    assert wc.launches['warp_homography_gray'] == \
        before['warp_homography_gray'] + (source == 'gray')
    ref = augment.warp_mold_torch(src, Ms, ident, MEAN, interp)
    assert got.shape == (b, 3, h, w) and got.is_contiguous()
    _fused_check(got, ref, interp)
    tiles = b * -(-h // wc.TILE) * -(-w // wc.TILE)
    assert int(stats[1]) == tiles
    if not wc.tma_addressable(src):
        assert int(stats[0]) == tiles        # every tile on the global path
        return
    # the tiles the numpy mirror of the kernel's plan puts on the global
    # path, over the images that are warped; and some partial tile (the
    # last row or column) of a warped image on the box path
    epp = 3 if source == 'rgb' else 1
    kinds = [tile_mirror.plan_tiles(M, h, w, epp)[0]
             for M, i in zip(Ms.cpu().numpy(), ident.cpu()) if not i]
    assert int(stats[0]) == sum(int((k == tile_mirror.GLOBAL).sum())
                                for k in kinds)
    if kinds and (h % wc.TILE or w % wc.TILE):
        assert any((k[-1] == tile_mirror.BOXED).any()
                   or (k[:, -1] == tile_mirror.BOXED).any() for k in kinds)


@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
def test_fused_kernel_global_path_matches_plain(cuda_device, interp):
    """Homographies whose boxes cannot fit (a horizon across the image, a
    10x zoom out, a zero denominator, NaN) beside ordinary ones: the tiles
    they flag read global memory, inside the same launch, and the result
    is the plain chain's."""
    from ursonet_torch import se3
    K = chip_smoke.net_intrinsics(chip_smoke.flagship_config())
    Kinv = np.linalg.inv(K)
    zero_den = np.zeros((3, 3))
    zero_den[0, 0] = 1.0
    Ms = np.stack([K @ se3.euler2SO3_left(80.0, 0.0, 0.0) @ Kinv,
                   np.diag([10.0, 10.0, 1.0]),
                   zero_den, np.full((3, 3), np.nan),
                   K @ se3.euler2SO3_left(3.0, -4.0, 40.0) @ Kinv,
                   np.eye(3)]).astype(np.float32)
    b, h, w = len(Ms), 512, 640
    rng = np.random.RandomState(12)
    src = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3), np.uint8)) \
        .to(cuda_device)
    Ms = torch.from_numpy(Ms).to(cuda_device)
    ident = torch.zeros(b, dtype=torch.bool, device=cuda_device)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    got = wc.warp_mold(src, Ms, ident, MEAN, interp, stats=stats)
    torch.cuda.synchronize()
    ref = augment.warp_mold_torch(src, Ms, ident, MEAN, interp)
    _fused_check(got, ref, interp)
    assert 0 < int(stats[0]) < int(stats[1])


def test_fused_kernel_unaligned_source_takes_the_global_path(cuda_device):
    """A contiguous u8 batch at an address TMA cannot take (not 16-byte
    aligned) is read from global memory by every tile, and is right."""
    b, h, w = 4, 64, 96
    rng = np.random.RandomState(13)
    buf = torch.from_numpy(rng.randint(0, 256, b * h * w * 3 + 1, np.uint8))
    src = buf.to(cuda_device)[1:].view(b, h, w, 3)
    assert src.is_contiguous() and not wc.tma_addressable(src)
    K = np.array([[60.0, 0, 48], [0, 60.0, 32], [0, 0, 1]])
    Ms = torch.from_numpy(chip_smoke.homographies(b, K, rng)).to(cuda_device)
    ident = torch.tensor([False, True, False, False], device=cuda_device)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for interp in ('nearest', 'bilinear'):
        stats.zero_()
        got = wc.warp_mold(src, Ms, ident, MEAN, interp, stats=stats)
        torch.cuda.synchronize()
        _fused_check(got, augment.warp_mold_torch(src, Ms, ident, MEAN,
                                                  interp), interp)
        assert int(stats[0]) == int(stats[1]) == b * 2 * 3


def test_fused_kernel_back_to_back_and_on_another_stream(cuda_device):
    """Launches of both sources and both interpolations back to back, then
    on a side stream: the same bits as one at a time (the cached tensor
    maps and launch sizes are per pointer and shape)."""
    cases = [FUSED_CASES['odd_rgb'], FUSED_CASES['odd_gray'],
             (2, 64, 96, 'rgb', 'urso'), (2, 64, 96, 'gray', 'urso')]
    inputs = [_fused_inputs(cuda_device, *c, seed=14 + i)
              for i, c in enumerate(cases)]
    ident = {b: IDENTITY['mixed'](b).to(cuda_device) for b in (2, 3)}
    want = [augment.warp_mold_torch(src, Ms, ident[len(src)], MEAN, interp)
            for src, Ms in inputs for interp in ('nearest', 'bilinear')]
    got = [wc.warp_mold(src, Ms, ident[len(src)], MEAN, interp)
           for src, Ms in inputs for interp in ('nearest', 'bilinear')]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = [wc.warp_mold(src, Ms, ident[len(src)], MEAN, interp)
                 for src, Ms in inputs for interp in ('nearest', 'bilinear')]
    torch.cuda.synchronize()
    for i, (g, a, r) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a)
        _fused_check(g, r, ('nearest', 'bilinear')[i % 2])


def test_fused_kernel_rejects_what_it_does_not_take(cuda_device):
    src, Ms = _fused_inputs(cuda_device, 2, 32, 48, 'rgb', 'urso', seed=15)
    ident = torch.zeros(2, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):                    # f32 NHWC
        wc.warp_mold(src.float(), Ms, ident, MEAN)
    with pytest.raises(ValueError):                    # u8 NCHW
        wc.warp_mold(src.permute(0, 3, 1, 2).contiguous(), Ms, ident, MEAN)
    with pytest.raises(ValueError):                    # strided rows
        wc.warp_mold(src[:, :, ::2], Ms[:, :, :], ident, MEAN)
    with pytest.raises(ValueError):                    # f64 gray plane
        wc.warp_mold(src[..., :1].permute(0, 3, 1, 2).double().contiguous(),
                     Ms, ident, MEAN)
    with pytest.raises(ValueError):                    # M on the CPU
        wc.warp_mold(src, Ms.cpu(), ident, MEAN)
    with pytest.raises(ValueError):                    # identity on the CPU
        wc.warp_mold(src, Ms, ident.cpu(), MEAN)
    with pytest.raises(ValueError):                    # identity not bool
        wc.warp_mold(src, Ms, ident.int(), MEAN)
    with pytest.raises(ValueError):
        wc.warp_mold(src, Ms, ident, MEAN, stats=torch.zeros(2))


def test_small_main_path_launches_the_fused_kernel(cuda_device):
    """The preprocess on the card runs the fused kernel once a step from
    the u8 batch, and no other warp launch."""
    wc.reset_counts()
    res = chip_smoke.run_main_path(chip_smoke.small_config(), cuda_device,
                                   seed=0, steps=3)
    chip_smoke.check_main_path(res)
    assert wc.launches['warp_mold'] == wc.launches['warp_homography'] == 4
    assert wc.launches['warp_homography_gray'] == 0


@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
def test_sim2real_preprocess_launches_the_fused_gray_kernel(cuda_device,
                                                            interp):
    """With sim2real the preprocess hands the gray plane to the fused
    kernel (one gray launch); that call equals the plain chain on the
    same inputs (chip_smoke's recorder and check)."""
    cfg = chip_smoke.small_config()
    cfg.SIM2REAL_AUG = True
    cfg.WARP_INTERPOLATION = interp
    cfg.update()
    raw = chip_smoke.make_raw_batch(cfg, 3)
    pre = chip_smoke.make_device_preprocess(cfg, device=cuda_device)
    draws = pre.draw(torch.Generator(cuda_device).manual_seed(4),
                     len(raw['images_u8']))
    wc.reset_counts()
    with chip_smoke._FusedWarps() as fused:
        batch = pre(raw, draws)
    torch.cuda.synchronize()
    assert wc.launches['warp_mold'] == wc.launches['warp_homography_gray'] \
        == wc.launches['warp_homography'] == 1
    src = fused.first[0]
    assert src.dtype == torch.float32 and src.shape[1] == 1
    assert chip_smoke.check_fused_call('sim2real', fused.first) <= (
        0.0 if interp == 'nearest' else 1e-3)
    assert torch.equal(batch['images'], fused.first[-1])


# --------------------------------------------------------------------------
# int8 kernels (csrc/int8_gemm.cu, csrc/int8_conv.cu)

from ursonet_torch.models.resnet import space_to_depth2  # noqa: E402
from ursonet_torch.ops import int8_cuda as ic  # noqa: E402

EPILOGUES = list(ic.EPILOGUES)


def _routes(picked):
    """The route the wrapper picks, and the mma.sync one forced where
    that is another."""
    return sorted({picked, 'ragged'}, reverse=True)


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('epilogue', EPILOGUES)
@pytest.mark.parametrize('m,k,n', [
    (77, 147, 13), (300, 64, 200), (2000, 96, 64), (1500, 40, 136),
    # the TMA + wgmma route: one row, a row past a tile, rows that end
    # mid-tile under every tile width, the narrowest and widest N, the
    # shallowest and deepest K (split over K below 1025 rows)
    (1, 16, 16), (129, 64, 48), (40960 + 37, 64, 256), (1317, 16, 13824),
    (129, 10240, 48), (128, 10240, 1024), (2085, 1024, 320),
    (5000, 256, 512)])
def test_gemm_s8_matches_plain(cuda_device, m, k, n, epilogue, acc):
    """Ragged M, K and N, every tile configuration, every epilogue in
    both accumulation modes, both routes where the shape allows the TMA
    one: bit-exact."""
    rng = np.random.RandomState(m + k + n)
    a = chip_smoke.s8(rng, (m, k), cuda_device)
    b = ic.kernel_layout(rng.randint(-128, 128, (k, n)).astype(np.int8)) \
        .to(cuda_device)
    kw = chip_smoke.epilogue_args(cuda_device, rng, (m, n), k, epilogue)
    kw['acc_dtype'] = acc
    want = ic.gemm_s8_torch(a, b, epilogue, **kw)
    for route in _routes(ic.gemm_route(m, k, n, epilogue, acc_dtype=acc)):
        before = ic.launches['gemm_s8']
        ic.calls = []
        got = ic.gemm_s8(a, b, epilogue, route=route, **kw)
        torch.cuda.synchronize()
        (_, call), ic.calls = ic.calls[0], None
        assert call['route'] == route
        assert call['acc'] == ('bf16' if acc == torch.bfloat16 else 'f32')
        assert ic.launches['gemm_s8'] == before + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), route


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('epilogue', EPILOGUES)
@pytest.mark.parametrize('geom', [
    # b, h, w, c, kh, kw, n, stride, padding
    (2, 9, 11, 3, 7, 7, 13, 2, ((3, 3), (3, 3))),
    (3, 7, 5, 32, 3, 3, 70, 1, ((1, 1), (1, 1))),
    (2, 8, 10, 48, 3, 3, 24, 2, ((0, 1), (0, 1))),
    (1, 6, 6, 20, 1, 1, 9, 2, ((0, 0), (0, 0))),
    # the TMA + wgmma route: H * W no multiple of the tile and a batch
    # boundary inside one, C = 16, stride 2 with pads (0, 1), C = 2048,
    # many tiles a block, a 1x1 and a 5x5 kernel
    (2, 9, 11, 16, 3, 3, 16, 1, ((1, 1), (1, 1))),
    (3, 7, 5, 32, 3, 3, 80, 1, ((1, 1), (1, 1))),
    (2, 8, 10, 48, 3, 3, 32, 2, ((0, 1), (0, 1))),
    (1, 6, 5, 2048, 3, 3, 128, 2, ((0, 1), (0, 1))),
    (40, 32, 40, 64, 3, 3, 256, 1, ((1, 1), (1, 1))),
    (2, 6, 6, 32, 1, 1, 16, 2, ((0, 0), (0, 0))),
    (1, 9, 7, 16, 5, 5, 48, 1, ((2, 2), (2, 2)))])
def test_conv_s8_matches_plain(cuda_device, geom, epilogue, acc):
    b, h, w, c, kh, kw, n, stride, padding = geom
    rng = np.random.RandomState(b * h * w + c + n)
    x = chip_smoke.s8(rng, (b, h, w, c), cuda_device)
    wt = ic.kernel_layout(rng.randint(-128, 128, (kh, kw, c, n))
                          .astype(np.int8)).to(cuda_device)
    oh, ow = ic.conv_out_hw(h, w, kh, kw, stride, padding)
    kw_ = chip_smoke.epilogue_args(cuda_device, rng, (b, oh, ow, n),
                                   kh * kw * c, epilogue)
    kw_['acc_dtype'] = acc
    want = ic.conv_s8_torch(x, wt, stride, padding, epilogue, **kw_)
    for route in _routes(ic.conv_route(c, n, kh * kw)):
        before = ic.launches['conv_s8']
        got = ic.conv_s8(x, wt, stride, padding, epilogue, route=route,
                         **kw_)
        torch.cuda.synchronize()
        assert ic.launches['conv_s8'] == before + 1
        assert got.shape == (b, oh, ow, n) and got.dtype == want.dtype
        assert torch.equal(got, want), route


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['gemm', 'conv'])
def test_int8_kernels_above_2_24_match_plain(cuda_device, kind, acc):
    """Accumulators above 2^24 (C5's depth of 4608, operands near 127;
    the bf16 mode rounds them to f32 and then to bf16, twice), every
    epilogue, both routes: bit-exact."""
    rng = np.random.RandomState(24)
    for case in chip_smoke.big_acc_cases(cuda_device, rng, kind):
        fn, plain, name = case
        for ep in EPILOGUES:
            want = plain(ep, acc)
            for route in ('tma', 'ragged'):
                got = fn(ep, acc, route)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype
                assert torch.equal(got, want), (name, ep, route)


# The joins' residuals: an int8 shortcut, and the float shortcut of an
# artifact without the shortcut requant sites ('float': the 'f32'
# epilogue's f32, or bf16 in the bf16 mode, for `join`; join_s8 takes
# 'f32_sum', f32 in both modes).
JOIN_RES = [('join', 's8'), ('join', 'float'), ('join_s8', 's8'),
            ('join_s8', 'f32')]
PADS = ((1, 1), (1, 1))


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('epilogue,res', JOIN_RES)
@pytest.mark.parametrize('kind,shape', [
    # the pruned flagship's 2c joins: K = 40 and 152 (ragged), 304 (TMA)
    ('gemm', (1500, 40, 256)), ('gemm', (700, 152, 1024)),
    ('gemm', (2085, 304, 2048)),
    # C2's 2c join; resident weights beside which the f32 residual's
    # slots leave room for fewer stages
    ('gemm', (40960 + 37, 64, 256)), ('gemm', (5000, 128, 512)),
    # basic-block conv2 joins: C = N = 40 (ragged), a tile's worth of
    # rows past a batch boundary, C2 of ResNet-18
    ('conv', (2, 9, 11, 40, 3, 3, 40, 1, PADS)),
    ('conv', (3, 7, 5, 32, 3, 3, 80, 1, PADS)),
    ('conv', (4, 16, 20, 64, 3, 3, 64, 1, PADS))])
def test_joins_match_plain(cuda_device, kind, shape, epilogue, res, acc):
    """join and join_s8 over int8 and float residuals, in both
    accumulation modes, on the route the wrapper picks and on the
    mma.sync one: bit-exact, counted by residual type."""
    rng = np.random.RandomState(sum(shape[:7]))
    rname = ('bf16' if acc == torch.bfloat16 else 'f32') \
        if res == 'float' else res
    if kind == 'gemm':
        m, k, n = shape
        a = chip_smoke.s8(rng, (m, k), cuda_device)
        w = ic.kernel_layout(rng.randint(-128, 128, (k, n))
                             .astype(np.int8)).to(cuda_device)
        kw = chip_smoke.epilogue_args(cuda_device, rng, (m, n), k, epilogue,
                                      rname)
        picked = ic.gemm_route(m, k, n, epilogue, acc_dtype=acc)
        assert picked == ('tma' if k % 16 == 0 else 'ragged')

        def launch(route):
            return ic.gemm_s8(a, w, epilogue, route=route, acc_dtype=acc,
                              **kw)
        want = ic.gemm_s8_torch(a, w, epilogue, acc_dtype=acc, **kw)
        rb = kw['res'].element_size() if rname != 's8' else 0
        plan = ic.hopper_plan(m, k, n, epilogue, ic._sms(cuda_device),
                              acc_dtype=acc, res_bytes=rb)
        if (m, k, n) == (5000, 128, 512) and rb:
            s8_plan = ic.hopper_plan(m, k, n, epilogue, ic._sms(cuda_device),
                                     acc_dtype=acc)
            assert plan['resident'] and s8_plan['resident']
            assert (plan['stages'], plan['bufs']) \
                < (s8_plan['stages'], s8_plan['bufs'])
    else:
        b, h, wd, c, kh, kw_, n, stride, pads = shape
        x = chip_smoke.s8(rng, (b, h, wd, c), cuda_device)
        w = ic.kernel_layout(rng.randint(-128, 128, (kh, kw_, c, n))
                             .astype(np.int8)).to(cuda_device)
        oh, ow = ic.conv_out_hw(h, wd, kh, kw_, stride, pads)
        kw = chip_smoke.epilogue_args(cuda_device, rng, (b, oh, ow, n),
                                      kh * kw_ * c, epilogue, rname)
        picked = ic.conv_route(c, n)
        assert picked == ('tma' if c % 16 == 0 and n % 16 == 0
                          else 'ragged')

        def launch(route):
            return ic.conv_s8(x, w, stride, pads, epilogue, route=route,
                              acc_dtype=acc, **kw)
        want = ic.conv_s8_torch(x, w, stride, pads, epilogue, acc_dtype=acc,
                                **kw)
    name = 'gemm_s8' if kind == 'gemm' else 'conv_s8'
    for route in _routes(picked):
        ic.reset_counts()
        got = launch(route)
        torch.cuda.synchronize()
        assert ic.join_launches == {(name, epilogue, rname): 1}
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert torch.equal(got, want), route


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', [(1317, 64, 256), (700, 40, 136)])
def test_f32_sum_matches_plain(cuda_device, shape, acc):
    """f32_sum (the float shortcut join_s8 takes) on both routes: the
    bf16 mode's sum before its last rounding, as f32, bit-exact."""
    m, k, n = shape
    a, b, kw = _gemm_operands(cuda_device, m, k, n, 'f32_sum')
    want = ic.gemm_s8_torch(a, b, 'f32_sum', acc_dtype=acc, **kw)
    assert want.dtype == torch.float32
    for route in _routes(ic.gemm_route(m, k, n, 'f32_sum', acc_dtype=acc)):
        got = ic.gemm_s8(a, b, 'f32_sum', route=route, acc_dtype=acc, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), route


def _gemm_operands(dev, m, k, n, epilogue, seed=0):
    rng = np.random.RandomState(seed)
    a = chip_smoke.s8(rng, (m, k), dev)
    b = ic.kernel_layout(rng.randint(-128, 128, (k, n)).astype(np.int8)) \
        .to(dev)
    return a, b, chip_smoke.epilogue_args(dev, rng, (m, n), k, epilogue)


@pytest.mark.parametrize('epilogue', ['f32', 'q8_relu'])
def test_split_k_gives_the_same_bits_on_every_run(cuda_device, epilogue):
    m, k, n = 128, 10240, 1024
    assert ic.hopper_plan(m, k, n, epilogue)['splits'] > 1
    a, b, kw = _gemm_operands(cuda_device, m, k, n, epilogue)
    runs = [ic.gemm_s8(a, b, epilogue, route='tma', **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert torch.equal(runs[0], ic.gemm_s8(a, b, epilogue, route='ragged',
                                           **kw))


def test_tma_route_on_another_stream(cuda_device):
    a, b, kw = _gemm_operands(cuda_device, 3000, 256, 512, 'join')
    want = ic.gemm_s8_torch(a, b, 'join', **kw)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = ic.gemm_s8(a, b, 'join', route='tma', **kw)
    stream.synchronize()
    assert torch.equal(got, want)


def test_tma_route_shapes_back_to_back(cuda_device):
    """Different shapes, tiles and epilogues launched without a
    synchronize between them: every launch carries its own tensor maps
    and tile counters."""
    shapes = [(2000, 64, 256, 'join'), (128, 10240, 256, 'f32'),
              (129, 64, 48, 'q8'), (128, 10240, 256, 'f32'),
              (5000, 512, 128, 'q8_relu'), (2000, 64, 256, 'join')]
    ops = [_gemm_operands(cuda_device, m, k, n, ep, seed=i)
           for i, (m, k, n, ep) in enumerate(shapes)]
    got = [ic.gemm_s8(a, b, ep, route='tma', **kw)
           for (a, b, kw), (_, _, _, ep) in zip(ops, shapes)]
    torch.cuda.synchronize()
    for out, (a, b, kw), (_, _, _, ep) in zip(got, ops, shapes):
        assert torch.equal(out, ic.gemm_s8_torch(a, b, ep, **kw))


def test_tma_route_under_load_gives_the_same_bits(cuda_device):
    """Served shapes of every tile width (GEMM and conv, resident and
    streamed weights, join, split K) launched back to back in shuffled
    order, 30 rounds of 3 launches each: every output equals the first
    round's, which equals the mma.sync route's."""
    rng = np.random.RandomState(7)
    cases = []
    for i, (m, k, n, ep) in enumerate([
            (163840, 64, 256, 'join'), (163840, 256, 1024, 'join'),
            (40960, 2048, 512, 'q8_relu'), (163840, 256, 64, 'q8_relu'),
            (163840, 512, 128, 'q8'), (128, 10240, 1024, 'f32_relu')]):
        a, b, kw = _gemm_operands(cuda_device, m, k, n, ep, seed=i)
        cases.append(lambda r, a=a, b=b, ep=ep, kw=kw:
                     ic.gemm_s8(a, b, ep, route=r, **kw))
    for c, n, hw in [(64, 64, (64, 80)), (256, 256, (32, 40))]:
        x = chip_smoke.s8(rng, (16, *hw, c), cuda_device)
        w = ic.kernel_layout(rng.randint(-128, 128, (3, 3, c, n))
                             .astype(np.int8)).to(cuda_device)
        kw = chip_smoke.epilogue_args(cuda_device, rng, (16, *hw, n), 9 * c,
                                      'q8_relu')
        cases.append(lambda r, x=x, w=w, kw=kw: ic.conv_s8(
            x, w, 1, ((1, 1), (1, 1)), 'q8_relu', route=r, **kw))
    first = [fn('ragged') for fn in cases]
    for _ in range(30):
        order = rng.permutation(len(cases))
        outs = [(i, [cases[i]('tma') for _ in range(3)][-1]) for i in order]
        torch.cuda.synchronize()
        for i, out in outs:
            assert torch.equal(out, first[i]), i


def test_forced_tma_route_refuses_what_it_cannot_address(cuda_device):
    a, b, kw = _gemm_operands(cuda_device, 77, 147, 13, 's32')
    with pytest.raises(ValueError):
        ic.gemm_s8(a, b, 's32', route='tma')
    with pytest.raises(ValueError):
        ic.gemm_s8(a, b, 's32', route='wgmma')
    x = chip_smoke.s8(np.random.RandomState(0), (1, 8, 8, 3), cuda_device)
    w = ic.kernel_layout(np.ones((7, 7, 3, 16), np.int8)).to(cuda_device)
    with pytest.raises(ValueError):
        ic.conv_s8(x, w, 2, ((3, 3), (3, 3)), route='tma')


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


@pytest.mark.parametrize('f16', [True, False])
def test_small_int8_serve_bias_corrected_on_the_card(cuda_device, f16):
    """calibrate, smooth and bias_correct on the card (its capture passes
    launch the kernels' s32 mode), in both accumulation modes: every
    quantized site gets a finite delta, the served outputs equal the
    plain path's and stay within the random-init gate of the float
    twin."""
    from ursonet_torch.engine import ServingEngine
    from ursonet_torch.models import quant as tq
    cfg = chip_smoke.small_serving_config()
    cfg.F16 = f16
    eng = ServingEngine(cfg, cuda_device,
                        generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (cfg.BATCH_SIZE, 64, 64, 3)).astype(np.uint8)
    qm = eng.quantize(list(imgs))
    qm.smooth(0.5)
    ic.reset_counts()
    report = qm.bias_correct(imgs, passes=1)
    assert ic.launches['gemm_s8'] > 0 and ic.launches['conv_s8'] > 0
    assert set(report) == set(qm.flat) - tq.float_sites(qm._mcfg)
    assert all(np.isfinite(v).all() for v in qm.bias_delta.values())
    out = eng.predict_molded(imgs)
    plain = qm(imgs, plain=True)
    flt = qm.float_twin(imgs)
    for k in out:
        torch.testing.assert_close(out[k], plain[k], rtol=0, atol=0)
        assert chip_smoke.rel(out[k], flt[k]) < tq.RANDOM_INIT_GATE_REL


def _knob_serving_config(**knobs):
    """chip_smoke.small_serving_config() under serving knobs."""
    cfg = chip_smoke.small_serving_config()
    for k, v in knobs.items():
        setattr(cfg, k, v)
    cfg.update()
    return cfg


@pytest.mark.parametrize('knobs', [
    dict(INNER_WIDTH_MULT=0.6), dict(INNER_WIDTH_MULT=0.6, F16=False),
    dict(QUANT_FLOAT_CLS_FINAL=True), dict(QUANT_FLOAT_REG_HEAD=True),
    dict(QUANT_S8_JOIN=True), dict(QUANT_BF16_STEM=True),
    dict(QUANT_S8_JOIN=True, QUANT_BF16_STEM=True, F16=False)],
    ids=lambda k: ','.join(f'{n}={v}' for n, v in k.items()))
def test_small_serve_under_the_knobs_equals_plain(cuda_device, knobs):
    """The small flagship served on the card under a serving knob: the
    pruned width at 0.6 (its 40- and 152-wide products on the mma.sync
    route, the rest on TMA), the float head knobs, the integer joins,
    the bf16 stem: the served heads equal the plain path's bit for bit,
    within the random-init gate of the float twin."""
    from ursonet_torch.engine import ServingEngine
    from ursonet_torch.models import quant as tq
    cfg = _knob_serving_config(**knobs)
    eng = ServingEngine(cfg, cuda_device,
                        generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (cfg.BATCH_SIZE, 64, 64, 3)).astype(np.uint8)
    qm = eng.quantize(list(imgs))
    qm.smooth(0.5)
    ic.reset_counts()
    ic.calls = []
    out = eng.predict_molded(imgs)
    torch.cuda.synchronize()
    calls, ic.calls = ic.calls, None
    routes = {a['route'] for n, a in calls
              if n != 'stem_s8' and not (n == 'conv_s8' and a['c'] == 3)}
    assert routes == ({'tma', 'ragged'} if 'INNER_WIDTH_MULT' in knobs
                      else {'tma'})
    # the `base` stem section: one launch of the fused stem's 'nhwc'
    # route, none under the bf16 stem
    assert [a['route'] for n, a in calls if n == 'stem_s8'] == (
        [] if cfg.QUANT_BF16_STEM else ['nhwc'])
    if cfg.QUANT_S8_JOIN:
        assert {k[1] for k in ic.join_launches} == {'join_s8'}
    plain = qm(imgs, plain=True)
    flt = qm.float_twin(imgs)
    for k in out:
        torch.testing.assert_close(out[k], plain[k], rtol=0, atol=0)
        assert chip_smoke.rel(out[k], flt[k]) < tq.RANDOM_INIT_GATE_REL


# --------------------------------------------------------------------------
# the fused stem (csrc/int8_stem.cu)


def _stem_operands(dev, rng, b, h2, w2):
    x = torch.from_numpy(rng.randint(0, 256, (b, h2, w2, 12))
                         .astype(np.uint8)).to(dev)
    w = ic.kernel_layout(rng.randint(-127, 128, (4, 4, 12, 64))
                         .astype(np.int8)).to(dev)
    return x, w


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('mode', list(ic.STEM_MODES))
@pytest.mark.parametrize('b,h2,w2', [(2, 64, 32), (3, 37, 51), (1, 5, 3),
                                     (2, 16, 34), (1, 256, 320),
                                     # the tma route: tiles that overhang
                                     # every border, a tiny image, the
                                     # flagship shape at batch 8
                                     (3, 37, 52), (2, 29, 76), (1, 5, 4),
                                     (8, 256, 320)])
def test_stem_s8_matches_plain(cuda_device, b, h2, w2, mode, acc):
    """Even, odd and tiny sizes (tiles that overhang every border, the
    (1, 1) pool padding of odd sizes), both input modes, both
    accumulation modes, the route the wrapper picks and the mma.sync one
    forced: bit-exact."""
    rng = np.random.RandomState(b * h2 + w2)
    x, w = _stem_operands(cuda_device, rng, b, h2, w2)
    kw = chip_smoke.stem_args(cuda_device, rng, mode)
    kw['acc_dtype'] = acc
    want = ic.stem_s8_torch(x, w, **kw)
    for route in _routes(ic.stem_route(w2)):
        before = ic.launches['stem_s8']
        ic.calls = []
        got = ic.stem_s8(x, w, route=route, **kw)
        torch.cuda.synchronize()
        (_, call), ic.calls = ic.calls[0], None
        assert call['route'] == route
        assert ic.launches['stem_s8'] == before + 1
        assert got.shape == (b, -(-h2 // 2), -(-w2 // 2), 64)
        assert got.dtype == torch.int8 and torch.equal(got, want), route
        assert int(got.max()) > 0


def test_stem_routes_under_load_give_the_same_bits(cuda_device):
    """Both routes at five shapes and both modes launched back to back in
    shuffled order, 20 rounds: every output equals the plain version's."""
    rng = np.random.RandomState(11)
    cases = []
    for i, (b, h2, w2) in enumerate([(16, 256, 320), (3, 37, 52),
                                     (2, 29, 76), (4, 64, 32),
                                     (5, 40, 100)]):
        x, w = _stem_operands(cuda_device, rng, b, h2, w2)
        kw = chip_smoke.stem_args(cuda_device, rng,
                                  list(ic.STEM_MODES)[i % 2])
        cases.append((x, w, kw, ic.stem_s8_torch(x, w, **kw)))
    for _ in range(20):
        order = rng.permutation(2 * len(cases))
        outs = [(i, ic.stem_s8(*cases[i // 2][:2], route=ic.ROUTES[i % 2],
                               **cases[i // 2][2])) for i in order]
        torch.cuda.synchronize()
        for i, out in outs:
            assert torch.equal(out, cases[i // 2][3]), i


def test_forced_stem_route_refuses_what_it_cannot_address(cuda_device):
    rng = np.random.RandomState(1)
    kw = chip_smoke.stem_args(cuda_device, rng, 'calibrated')
    x, w = _stem_operands(cuda_device, rng, 1, 8, 10)      # W2 % 4 == 2
    with pytest.raises(ValueError):
        ic.stem_s8(x, w, route='tma', **kw)
    with pytest.raises(ValueError):
        ic.stem_s8(x, w, route='wgmma', **kw)
    x, w = _stem_operands(cuda_device, rng, 1, 8, 16)
    buf = torch.empty(x.numel() + 4, dtype=torch.uint8, device=cuda_device)
    x4 = buf[4:].view(x.shape)                               # 4-byte aligned
    x4.copy_(x)
    assert ic.stem_route(16, ic._aligned(x4)) == 'ragged'
    with pytest.raises(ValueError):
        ic.stem_s8(x4, w, route='tma', **kw)
    assert torch.equal(ic.stem_s8(x4, w, **kw), ic.stem_s8_torch(x, w, **kw))


def test_stem_s8_rejects_what_it_does_not_take(cuda_device):
    rng = np.random.RandomState(0)
    x, w = _stem_operands(cuda_device, rng, 1, 8, 8)
    kw = chip_smoke.stem_args(cuda_device, rng, 'calibrated')
    with pytest.raises(ValueError):
        ic.stem_s8(x.to(torch.int8), w, **kw)                 # not uint8
    with pytest.raises(ValueError):
        ic.stem_s8(x[..., :3].contiguous(), w, **kw)          # not packed
    with pytest.raises(ValueError):
        ic.stem_s8(x, w.contiguous(), **kw)                   # HWIO memory
    with pytest.raises(ValueError):
        ic.stem_s8(x, w, **dict(kw, mode='bogus'))
    with pytest.raises(ValueError):
        ic.stem_s8(x, w, **dict(kw, mean=(1.0, 2.0, 3.0)))
    with pytest.raises(ValueError):
        ic.stem_s8(x, w, **dict(kw, alpha=kw['alpha'].cpu()))


# the 'nhwc' route: (batch, H, W) of raw batches it takes: tiles that
# overhang every border (H / 2 odd and even), one tile, the flagship's
# 512x640 (the full served batch in the next test)
NHWC_SHAPES = [(2, 74, 96), (3, 58, 208), (1, 10, 16), (2, 2, 32),
               (4, 512, 640)]


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('mode', list(ic.STEM_MODES))
@pytest.mark.parametrize('b,h,w', NHWC_SHAPES)
def test_stem_s8_nhwc_matches_plain_and_packed(cuda_device, b, h, w, mode,
                                               acc):
    """The 'nhwc' route on the raw batch equals its plain version (the
    7x7 chain) and the 'tma' route on the same pixels packed, both input
    modes, both accumulation modes: bit for bit."""
    rng = np.random.RandomState(b * h + w)
    x, w7, w4 = chip_smoke.nhwc_operands(cuda_device, rng, b, h, w)
    kw = dict(chip_smoke.nhwc_args(cuda_device, rng, mode), acc_dtype=acc)
    want = ic.stem_s8_nhwc_torch(x, w7, **kw)
    before = ic.launches['stem_s8']
    ic.calls = []
    got = ic.stem_s8(x, w4, **kw)
    torch.cuda.synchronize()
    (_, call), ic.calls = ic.calls[0], None
    assert call['route'] == 'nhwc' and ic.launches['stem_s8'] == before + 1
    assert got.shape == (b, -(-h // 4), -(-w // 4), 64)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    packed = ic.stem_s8(space_to_depth2(x).contiguous(), w4, route='tma',
                        **dict(kw, mean=np.tile(kw['mean'], 4)))
    assert torch.equal(packed, want)
    assert int(got.max()) > 0


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
def test_stem_s8_nhwc_at_the_served_batch(cuda_device, acc):
    """The flagship's served batch, 128 x 512x640: the 'nhwc' route
    equals its plain version (16 images at a time: the float64 conv is
    large) and the 'tma' route on the packed pixels."""
    rng = np.random.RandomState(128)
    x, w7, w4 = chip_smoke.nhwc_operands(cuda_device, rng, 128, 512, 640)
    kw = dict(chip_smoke.nhwc_args(cuda_device, rng, 'calibrated'),
              acc_dtype=acc)
    got = ic.stem_s8(x, w4, **kw)
    packed = ic.stem_s8(space_to_depth2(x).contiguous(), w4, route='tma',
                        **dict(kw, mean=np.tile(kw['mean'], 4)))
    torch.cuda.synchronize()
    assert torch.equal(got, packed)
    for i in range(0, 128, 16):
        assert torch.equal(got[i:i + 16],
                           ic.stem_s8_nhwc_torch(x[i:i + 16], w7, **kw)), i


def test_stem_s8_nhwc_refuses_what_it_cannot_address(cuda_device):
    """Raw batches the 'nhwc' route does not take raise (odd H, W not a
    multiple of 16, a pointer off 16 bytes, a forced packed route), and
    the stem's route says so from the shapes alone."""
    rng = np.random.RandomState(2)
    kw = chip_smoke.nhwc_args(cuda_device, rng, 'calibrated')
    for h, w in ((9, 16), (10, 24)):
        x, _, w4 = chip_smoke.nhwc_operands(cuda_device, rng, 1, h, w)
        assert ic.stem_route(w, True, 3, h) is None
        with pytest.raises(ValueError):
            ic.stem_s8(x, w4, **kw)
    x, _, w4 = chip_smoke.nhwc_operands(cuda_device, rng, 1, 10, 16)
    assert ic.stem_route(16, True, 3, 10) == 'nhwc'
    for route in ic.ROUTES:
        with pytest.raises(ValueError):
            ic.stem_s8(x, w4, route=route, **kw)
    buf = torch.empty(x.numel() + 4, dtype=torch.uint8, device=cuda_device)
    x4 = buf[4:].view(x.shape)                               # 4-byte aligned
    x4.copy_(x)
    assert ic.stem_route(16, ic._aligned(x4), 3, 10) is None
    with pytest.raises(ValueError):
        ic.stem_s8(x4, w4, **kw)
    with pytest.raises(ValueError):
        ic.stem_s8(x, w4, **dict(kw, mean=np.tile(kw['mean'], 4)))


@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('backbone', ['resnet50', 'resnet18'])
def test_base_batch_equals_the_unfused_chain(cuda_device, backbone, f16):
    """A `base` model on a uint8 batch (the stem section in one 'nhwc'
    launch) and on the same batch molded in float (input quantize ->
    conv_s8 on the ragged route -> maxpool): the same bits, and each
    takes its route."""
    from ursonet_torch.engine import ServingEngine
    cfg = chip_smoke.small_serving_config('base')
    cfg.BACKBONE, cfg.F16 = backbone, f16
    cfg.update()
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    eng = ServingEngine(cfg, cuda_device,
                        generator=torch.Generator().manual_seed(0))
    qm = eng.quantize(list(imgs))
    x = torch.from_numpy(imgs).to(cuda_device)
    molded = x.float() - torch.tensor(cfg.MEAN_PIXEL, dtype=torch.float32,
                                      device=cuda_device)
    outs, stems = {}, {}
    for name, inp in (('u8', x), ('molded', molded)):
        ic.calls = []
        outs[name] = qm(inp)
        torch.cuda.synchronize()
        calls, ic.calls = ic.calls, None
        stems[name] = [a['route'] for n, a in calls if n == 'stem_s8'] + [
            a['route'] for n, a in calls if n == 'conv_s8' and a['c'] == 3]
    assert stems == {'u8': ['nhwc'], 'molded': ['ragged']}
    for k in outs['u8']:
        assert torch.equal(outs['u8'][k], outs['molded'][k]), k
    plain = qm(x, plain=True)
    for k in plain:
        assert torch.equal(outs['u8'][k], plain[k]), k


@pytest.mark.parametrize('variant', ['s2d', 'host_s2d'])
def test_small_s2d_serve_launches_the_stem(cuda_device, variant):
    """A small int8 serve of the s2d variants through the engine: one
    stem_s8 launch per batch, outputs equal to the plain path's and, bit
    for bit in the int8 body, to the base variant's."""
    from ursonet_torch.engine import ServingEngine
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    outs = {}
    for v in ('base', variant):
        cfg = chip_smoke.small_serving_config(v)
        eng = ServingEngine(cfg, cuda_device,
                            generator=torch.Generator().manual_seed(0))
        eng.quantize(list(imgs))
        ic.reset_counts()
        ic.calls = []
        outs[v] = eng.predict_molded(imgs)
        torch.cuda.synchronize()
        calls, ic.calls = ic.calls, None
        assert ic.launches['stem_s8'] == 1
        # the served stem takes the persistent TMA + wgmma kernel: on the
        # raw batch (`base`, `s2d`) or on the host's packed pixels
        assert [a['route'] for n, a in calls if n == 'stem_s8'] == (
            ['tma'] if v == 'host_s2d' else ['nhwc'])
        plain = eng.qmodel(eng._host_s2d_maybe(imgs), plain=True)
        for k in plain:
            torch.testing.assert_close(outs[v][k], plain[k], rtol=1e-6,
                                       atol=1e-6)
    for k in outs['base']:
        assert torch.isfinite(outs[variant][k]).all()


# --------------------------------------------------------------------------
# the fused bottleneck block (csrc/int8_block.cu)

@pytest.mark.parametrize('b,h,w', [(1, 8, 16), (2, 13, 21), (1, 3, 5),
                                   (3, 24, 40), (1, 128, 160),
                                   # the persistent walk: 165 tiles, not a
                                   # multiple of the 132 SMs
                                   (3, 40, 176)])
def test_block_s8_matches_plain_and_unfused(cuda_device, b, h, w):
    """One tile, ragged tiles on every border, an image smaller than a
    tile, many tiles: equal to the plain version and to the unfused
    route through gemm_s8 / conv_s8, bit for bit."""
    ops = fb.operands(b, h, w, seed=b * h + w, device=cuda_device)
    before = fb.launches['block_s8']
    got = fb.block_s8(*ops)
    torch.cuda.synchronize()
    assert fb.launches['block_s8'] == before + 1
    assert torch.equal(got, fb.block_s8_torch(*ops))
    assert torch.equal(got, fb.block_s8_unfused(*ops))
    assert 0 < int(got.max()) <= 127 and int(got.min()) >= 0


def test_block_s8_back_to_back_gives_the_same_bits(cuda_device):
    """Five shapes, each twice a round, launched back to back in shuffled
    order, 20 rounds: every output equals the plain version's."""
    rng = np.random.RandomState(7)
    cases = []
    for i, (b, h, w) in enumerate([(8, 128, 160), (3, 40, 176), (2, 13, 21),
                                   (1, 3, 5), (4, 24, 40)]):
        ops = fb.operands(b, h, w, 100 + i, cuda_device)
        cases.append((ops, fb.block_s8_torch(*ops)))
    for _ in range(20):
        order = rng.permutation(2 * len(cases))
        outs = [(i, fb.block_s8(*cases[i % len(cases)][0])) for i in order]
        torch.cuda.synchronize()
        for i, out in outs:
            assert torch.equal(out, cases[i % len(cases)][1]), i


def test_block_s8_rejects_what_it_does_not_take(cuda_device):
    x, w1, w2, w3, ab = fb.operands(1, 8, 8, 0, cuda_device)
    with pytest.raises(ValueError):
        fb.block_s8(x[..., :128].contiguous(), w1, w2, w3, ab)   # Cin 128
    with pytest.raises(ValueError):
        fb.block_s8(x, w1.contiguous(), w2, w3, ab)          # row-major [K,N]
    with pytest.raises(ValueError):
        fb.block_s8(x, w1, w2, w3, ab[:, :64].contiguous())
    with pytest.raises(ValueError):
        fb.block_s8(x.float(), w1, w2, w3, ab)
    with pytest.raises(ValueError):
        fb.block_s8(x, w1, w2, w3.cpu(), ab)
    buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda_device)
    x4 = buf[4:4 + x.numel()].view(x.shape)   # off 16 bytes: no tensor map
    x4.copy_(x)
    with pytest.raises(ValueError):
        fb.block_s8(x4, w1, w2, w3, ab)


# --------------------------------------------------------------------------
# the tensor-core rate loops (csrc/mma_rate.cu)


@pytest.mark.parametrize('route', list(mr.ROUTES))
@pytest.mark.parametrize('kind', list(mr.KINDS))
@pytest.mark.parametrize('m,n,k', [(128, 128, 64), (256, 256, 256),
                                   (128, 256, 1024), (64, 128, 2048),
                                   (128, 256, 96)])
def test_mma_rate_matches_plain(cuda_device, kind, m, n, k, route):
    """Every block tile of each route (K picks it), a depth that ends
    mid K-block, iters 0, 1 and 4: the integer kinds exact in every
    replica; bf16 within BF16_RATE_TOL of the output's largest magnitude
    (f32 accumulation in another order)."""
    if kind == 'bf16':
        k //= 2         # 2 bytes a value: the same rows in shared memory
    bm, bn = mr.tile_for(kind, k, route)
    m, n = -(-m // bm) * bm, -(-n // bn) * bn
    a, b = mr.operands(kind, m, n, k, seed=m + k, device=cuda_device)
    if k % mr.k_step(kind, route):      # s4 K = 96 on the mma_sync route
        with pytest.raises(ValueError):
            mr.mma_rate(a, b, 1, kind, route=route)
        return
    for iters in (0, 1, 4):
        key = f'mma_rate_{kind}_{route}'
        before = mr.launches[key]
        got = mr.mma_rate(a, b, iters, kind, replicas=3, all_replicas=True,
                          route=route)
        torch.cuda.synchronize()
        assert mr.launches[key] == before + 1
        want = mr.mma_rate_torch(a, b, iters, kind)
        assert got.shape == (3, m, n) and got.dtype == want.dtype
        for r in range(3):
            if kind == 'bf16':
                tol = chip_smoke.BF16_RATE_TOL * max(float(want.abs().max()),
                                                     1.0)
                assert float((got[r] - want).abs().max()) <= tol
            else:
                assert torch.equal(got[r], want)


@pytest.mark.parametrize('route', list(mr.ROUTES))
def test_mma_rate_wraps_int32(cuda_device, route):
    """Saturated operands overflow int32 within the loop; the kernel wraps
    as the plain version says."""
    a = torch.full((128, 512), 127, dtype=torch.int8, device=cuda_device)
    b = torch.full((256, 512), 127, dtype=torch.int8, device=cuda_device).t()
    got = mr.mma_rate(a, b, 512, 's8', route=route)
    want = mr.mma_rate_torch(a, b, 512, 's8')
    assert 127 * 127 * 512 * 512 > 2 ** 31 and torch.equal(got, want)


@pytest.mark.parametrize('kind', list(mr.KINDS))
def test_mma_rate_wgmma_time_is_linear_in_iters(cuda_device, kind):
    """A loop the compiler had hoisted would not scale with `iters`."""
    a, b = mr.operands(kind, 1024, 1024, 512, 0, cuda_device)
    ms = {it: chip_smoke.cuda_ms(lambda it=it: mr.mma_rate(
        a, b, it, kind, route='wgmma'), 3, 1) for it in (128, 256)}
    assert 1.7 <= ms[256] / ms[128] <= 2.3, ms


def test_forced_rate_routes_refuse_what_they_do_not_take(cuda_device):
    a, b = mr.operands('s8', 128, 128, 64, 0, cuda_device)
    with pytest.raises(ValueError):
        mr.mma_rate(a, b, 1, 's8', route='wgmma')          # N < 256, K < 128
    assert mr.rate_route('s8', 128, 128, 64) == 'mma_sync'
    assert torch.equal(mr.mma_rate(a, b, 3, 's8'),
                       mr.mma_rate_torch(a, b, 3, 's8'))
    a, b = mr.operands('bf16', 64, 32, 1024, 0, cuda_device)
    with pytest.raises(ValueError):
        mr.mma_rate(a, b, 1, 'bf16', route='mma_sync')     # N % 64
    assert mr.rate_route('bf16', 64, 32, 1024) == 'wgmma'
    with pytest.raises(ValueError):
        mr.mma_rate(a, b, 1, 'bf16', route='tma')


def test_mma_rate_rejects_what_it_does_not_take(cuda_device):
    a, b = mr.operands('s8', 128, 128, 64, 0, cuda_device)
    with pytest.raises(ValueError):
        mr.mma_rate(a, b, 1, 'fp8')
    with pytest.raises(ValueError):
        mr.mma_rate(a, b.contiguous(), 1, 's8')            # row-major [K,N]
    with pytest.raises(ValueError):
        mr.mma_rate(a[:100], b, 1, 's8')                   # M not a tile
    with pytest.raises(ValueError):
        mr.mma_rate(a, b, 1, 'bf16')                       # int8 operands
    with pytest.raises(ValueError):
        mr.mma_rate(a[:, :48].contiguous(), b[:48], 1, 's8')   # K % 32


# --------------------------------------------------------------------------
# bf16 training, REMAT and the keypoint head on the card

# Each gradient within chip_smoke.REMAT_CARD_REL (exact: see there) of
# its no-REMAT value, the bound chip_smoke.py holds config 5 to at full
# width.
REMAT_CARD_REL = chip_smoke.REMAT_CARD_REL


@pytest.mark.parametrize('n', [3, 5])
def test_f16_train_step_on_card_loss_falls(cuda_device, n):
    """The F16 flagship recipe (3) and config 5 (ResNet-101, keypoints,
    REMAT) at a small size: 3 steps on one batch, the loss falls, the
    warp kernel runs, the parameters stay f32."""
    cfg = chip_smoke.small_config(n)
    cfg.F16 = True
    cfg.update()
    before = wc.launches['warp_homography']
    res = chip_smoke.run_main_path(cfg, cuda_device, seed=0, steps=3)
    chip_smoke.check_main_path(res)
    assert wc.launches['warp_homography'] > before
    assert all(p.dtype == torch.float32 and p.is_cuda
               for p in res['model'].parameters())
    if n == 5:
        chip_smoke.decode_keypoint_validation(res, cfg, 0)


@pytest.mark.parametrize('remat', [True, 'narrow', 'dots'])
def test_remat_gradients_on_card_match_no_remat(cuda_device, remat):
    from ursonet_torch.models.ursonet import build_model
    cfg = chip_smoke.small_config(5)
    model = build_model(cfg, cuda_device, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 3, 64, 64).astype(np.float32) * 50).to(cuda_device)

    def grads(policy):
        model.backbone.set_remat(policy)
        out = model(x)
        loss = sum((v ** 2).mean() for v in out.values())
        return torch.autograd.grad(loss, list(model.parameters()))
    plain, checked = grads(False), grads(remat)
    for g0, g in zip(plain, checked):
        assert g.dtype == torch.float32
        assert float((g - g0).norm()) <= REMAT_CARD_REL * float(g0.norm())


def test_keypoint_decode_on_card_matches_cpu(cuda_device):
    from ursonet_torch import evaluate
    rng = np.random.RandomState(3)
    loc = np.stack([rng.uniform(-3, 3, 256), rng.uniform(-3, 3, 256),
                    rng.uniform(5, 40, 256)], 1).astype(np.float32)
    q = rng.randn(256, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k1, k2 = chip_smoke.keypoints_of(q, loc, 3.0)
    out = {'loc': loc, 'k1': k1 + rng.randn(256, 3).astype(np.float32),
           'k2': k2 + rng.randn(256, 3).astype(np.float32)}
    cfg = chip_smoke.small_config(5)
    on_cpu = evaluate.decode_results(
        {k: torch.from_numpy(v) for k, v in out.items()}, cfg)
    on_card = evaluate.decode_results(
        {k: torch.from_numpy(v).to(cuda_device) for k, v in out.items()}, cfg)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.mark.parametrize('int8', [False, True])
def test_detect_keypoints_on_card(cuda_device, int8):
    from ursonet_torch.engine import ServingEngine
    cfg = chip_smoke.small_config(5)
    eng = ServingEngine(cfg, cuda_device,
                        generator=torch.Generator().manual_seed(0))
    imgs = list(np.random.RandomState(0).randint(
        0, 256, (2, 64, 64, 3)).astype(np.uint8))
    if int8:
        eng.quantize(imgs)
    for r in eng.detect(imgs):
        assert set(r) == {'loc', 'k1', 'k2'}
        assert all(np.isfinite(v).all() and v.shape == (3,)
                   for v in r.values())


# --------------------------------------------------------------------------
# the training engine on the card


@pytest.fixture(scope='module')
def urso_frames(tmp_path_factory):
    from ursonet_torch.data.synthetic import make_urso_dataset
    d = str(tmp_path_factory.mktemp('urso'))
    make_urso_dataset(d, n_per_subset=6, width=96, height=72)
    return d


def _engine_datasets(d, cfg):
    from ursonet_torch.data.urso import Urso
    out = []
    for subset in ('train', 'val'):
        ds = Urso()
        ds.load_dataset(d, cfg, subset)
        out.append(ds)
    return out


@pytest.mark.parametrize('resident', [True, False])
def test_engine_trains_an_epoch_on_card(cuda_device, urso_frames, tmp_path,
                                        resident):
    """One UrsoNet.train epoch of the small flagship recipe on the card,
    device-resident or streamed from disk: finite losses, the warp
    launched, the resident data and the weights on the card."""
    from ursonet_torch.engine import UrsoNet
    cfg = chip_smoke.engine_config(chip_smoke.small_config())
    cfg.DATA_ON_DEVICE = resident
    train_ds, val_ds = _engine_datasets(urso_frames, cfg)
    eng = UrsoNet('training', cfg, str(tmp_path), device=cuda_device)
    before = wc.launches['warp_homography']
    logs = []
    means = eng.train(train_ds, val_ds, cfg.LEARNING_RATE, 1,
                      log_fn=logs.append)
    assert wc.launches['warp_homography'] > before
    assert all(np.isfinite(v) for v in means.values())
    assert logs[0].startswith('data: device-resident') == resident
    assert all(p.is_cuda for p in eng.model.parameters())
    assert all(v.is_cuda for v in eng.velocity.values())


def test_engine_resumes_on_card(cuda_device, urso_frames, tmp_path):
    """resume_state on the card: weights, velocity, step and epoch bit for
    bit, and the resumed engine trains on."""
    from ursonet_torch.engine import UrsoNet
    cfg = chip_smoke.engine_config(chip_smoke.small_config())
    train_ds, val_ds = _engine_datasets(urso_frames, cfg)
    eng = UrsoNet('training', cfg, str(tmp_path), device=cuda_device)
    eng.train(train_ds, val_ds, cfg.LEARNING_RATE, 1, log_fn=lambda *a: None)
    eng2 = UrsoNet('training', cfg, str(tmp_path), device=cuda_device)
    assert eng2.resume_state(eng.log_dir)
    assert (eng2.step, eng2.epoch) == (eng.step, 1)
    for a, b in ((eng2.model.state_dict(), eng.model.state_dict()),
                 (eng2.velocity, eng.velocity)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].is_cuda and torch.equal(a[k], b[k]), k
    eng2.train(train_ds, val_ds, cfg.LEARNING_RATE, 2, log_fn=lambda *a: None)
    assert eng2.epoch == 2


# --------------------------------------------------------------------------
# Keras h5 weights on the card


def test_h5_round_trip_of_the_flagship_on_card(cuda_device, tmp_path):
    """A full-width flagship (benchmark_config(3)) state_dict written by
    the port's HDF5 codec and loaded back onto the card: every tensor bit
    for bit, and the same forward bit for bit."""
    from ursonet_torch import presets
    from ursonet_torch.engine import UrsoNet
    cfg = presets.benchmark_config(3)
    cfg.IMAGES_PER_GPU = 2
    cfg.update()
    src = UrsoNet('inference', cfg, str(tmp_path), device=cuda_device)
    src.initialize(seed=3)
    path = str(tmp_path / 'flagship.h5')
    from ursonet_torch.checkpoint.h5_import import save_keras_h5
    save_keras_h5(path, src.model.state_dict())
    dst = UrsoNet('inference', cfg, str(tmp_path), device=cuda_device)
    dst.initialize(seed=4)
    dst.load_weights(path)
    a, b = src.model.state_dict(), dst.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].is_cuda and torch.equal(a[k], b[k]), k
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    x = torch.from_numpy(np.random.RandomState(0).rand(2, h, w, 3)
                         .astype(np.float32) * 100)
    want, got = src.predict_molded(x), dst.predict_molded(x)
    for k in want:
        assert got[k].is_cuda and torch.equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# SPEED: the gray route of the warp at config 4's shape, the JPEG codec


@pytest.mark.parametrize('interp', ['nearest', 'bilinear'])
def test_gray_warp_at_config4_shape_matches_plain(cuda_device, interp):
    """warp_cuda_gray on a broadcast gray batch (what sim2real hands the
    rotation) at benchmark_config(4)'s 4x640x960 with SPEED's camera:
    nearest exactly, bilinear within 1e-3; one gray launch."""
    b, h, w = chip_smoke.SPEED_TRAIN_SHAPE
    rng = np.random.RandomState(4)
    one = torch.from_numpy(
        (rng.rand(b, 1, h, w) * 255).astype(np.float32)).to(cuda_device)
    Ms = torch.from_numpy(chip_smoke.homographies(
        b, chip_smoke.speed_intrinsics(), rng)).to(cuda_device)
    plain = augment.warp_nearest_torch if interp == 'nearest' \
        else augment.warp_bilinear_torch
    before = dict(wc.launches)
    got = wc.warp_cuda_gray(one.expand(b, 3, h, w), Ms, interp)
    torch.cuda.synchronize()
    assert wc.launches['warp_homography_gray'] == \
        before['warp_homography_gray'] + 1
    assert got.shape == (b, 3, h, w)
    ref = plain(one, Ms)
    tol = 0.0 if interp == 'nearest' else 1e-3
    assert (got - ref).abs().max().item() <= tol


# sha256 of PIL's pixels of tests/data/jpeg_*.jpg (written by PIL: a gray
# frame at quality 75; an RGB 4:2:0 frame at quality 90 with a restart
# interval of 2 MCUs)
JPEG_GOLDEN = {
    'gray': ('ac4428b960b5aff10ddfaaba47148d0caa365676e755a69dac02ade8617972e9',
             (23, 37)),
    'rgb420': ('309654dc1a5db44b1cf057107c21a495ad384863e45ef05ad443d403917125c0',
               (37, 23, 3)),
}
# sha256 of the codec's file for JPEG_PATTERN at quality 75 (as built
# with g++ where PIL decodes it to the same pixels as PIL's own file)
JPEG_PATTERN_SHA = \
    'dfca1139df9790a537b3cb6b0d62a3e8034f3abf09a54ae9471ecab1c64ff8c6'


def _jpeg_pattern():
    y, x = np.mgrid[0:40, 0:56]
    return ((x * 7 + y * 13 + (x * y) % 17) % 256).astype(np.uint8)


@pytest.mark.parametrize('name', sorted(JPEG_GOLDEN))
def test_jpeg_codec_on_the_cards_host(name):
    """The codec built with the card machine's g++ decodes to PIL's
    pixels and encodes the bytes it encodes elsewhere (that machine has
    no PIL)."""
    import hashlib
    import os

    from ursonet_torch.data import jpeg
    path = os.path.join(os.path.dirname(__file__), 'data',
                        f'jpeg_{name}.jpg')
    with open(path, 'rb') as f:
        px = jpeg.decode_jpeg(f.read())
    sha, shape = JPEG_GOLDEN[name]
    assert px.shape == shape
    assert hashlib.sha256(px.tobytes()).hexdigest() == sha
    assert hashlib.sha256(jpeg.encode_jpeg(_jpeg_pattern())).hexdigest() \
        == JPEG_PATTERN_SHA


# --------------------------------------------------------------------------
# benchmark config 2 (ResNet-18 at 512x640, batch 1): the int8 kernels at
# the basic blocks' and the heads' shapes, and the native batch loader on
# the card's host

# conv: (b, h, w, c, n, stride, padding, epilogue) of the served model
CONFIG2_CONVS = [
    (1, 128, 160, 64, 64, 1, ((1, 1), (1, 1)), 'q8_relu'),    # stage1 conv1
    (1, 128, 160, 64, 64, 1, ((1, 1), (1, 1)), 'join'),       # stage1 conv2
    (1, 128, 160, 64, 128, 2, ((1, 1), (1, 1)), 'q8_relu'),   # stage2_unit1
    (1, 32, 40, 256, 256, 1, ((1, 1), (1, 1)), 'join'),       # stage3 conv2
    (1, 16, 20, 512, 32, 2, ((0, 1), (0, 1)), 'q8'),          # bottleneck
]
# gemm: (m, k, n, epilogue): the 1x1 shortcuts and the heads at batch 1
CONFIG2_GEMMS = [
    (128 * 160, 64, 64, 'q8'),        # stage1_unit1_sc (stride 1)
    (64 * 80, 64, 128, 'q8'),         # stage2_unit1_sc over strided pixels
    (8 * 10, 256, 512, 'q8'),         # stage4_unit1_sc
    (1, 32 * 8 * 10, 1024, 'f32_relu'),   # loc/ori dense_0 at batch 1
    (1, 32 * 8 * 10, 1024, 'q8_relu'),
]


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('geom', CONFIG2_CONVS)
def test_conv_s8_at_config2_shapes_matches_plain(cuda_device, geom, acc):
    b, h, w, c, n, stride, padding, epilogue = geom
    rng = np.random.RandomState(h + c + n)
    x = chip_smoke.s8(rng, (b, h, w, c), cuda_device)
    wt = ic.kernel_layout(rng.randint(-128, 128, (3, 3, c, n))
                          .astype(np.int8)).to(cuda_device)
    oh, ow = ic.conv_out_hw(h, w, 3, 3, stride, padding)
    kw = chip_smoke.epilogue_args(cuda_device, rng, (b, oh, ow, n), 9 * c,
                                  epilogue)
    kw['acc_dtype'] = acc
    want = ic.conv_s8_torch(x, wt, stride, padding, epilogue, **kw)
    assert ic.conv_route(c, n) == 'tma'
    for route in ('tma', 'ragged'):
        got = ic.conv_s8(x, wt, stride, padding, epilogue, route=route, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), route


@pytest.mark.parametrize('acc', ic.ACC_DTYPES, ids=['f32', 'bf16'])
@pytest.mark.parametrize('m,k,n,epilogue', CONFIG2_GEMMS)
def test_gemm_s8_at_config2_shapes_matches_plain(cuda_device, m, k, n,
                                                 epilogue, acc):
    """The shortcuts and, at batch 1 (one row: split over K), the heads,
    on both routes."""
    rng = np.random.RandomState(m + k + n)
    a = chip_smoke.s8(rng, (m, k), cuda_device)
    b = ic.kernel_layout(rng.randint(-128, 128, (k, n)).astype(np.int8)) \
        .to(cuda_device)
    kw = chip_smoke.epilogue_args(cuda_device, rng, (m, n), k, epilogue)
    kw['acc_dtype'] = acc
    want = ic.gemm_s8_torch(a, b, epilogue, **kw)
    assert ic.gemm_route(m, k, n, epilogue, acc_dtype=acc) == 'tma'
    for route in ('tma', 'ragged'):
        got = ic.gemm_s8(a, b, epilogue, route=route, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), route


@pytest.mark.parametrize('nthreads', [1, 8])
def test_native_loader_on_the_cards_host(tmp_path, nthreads):
    """The batch loader built with the card machine's g++ and zlib gives
    load_batch_plain's batch: PNG frames in every row filter and color
    type and the committed JPEGs, resized and placed."""
    import os

    from ursonet_torch.data import native_loader, png
    rng = np.random.RandomState(nthreads)
    paths = []
    for i, shape in enumerate([(96, 128, 3), (60, 80), (50, 70, 4),
                               (96, 128, 3), (48, 64, 3)]):
        path = str(tmp_path / f'{i}.png')
        with open(path, 'wb') as f:
            f.write(png.encode_png(
                rng.randint(0, 256, shape).astype(np.uint8), i))
        paths.append(path)
    paths += [os.path.join(os.path.dirname(__file__), 'data', name)
              for name in ('jpeg_gray.jpg', 'jpeg_rgb420.jpg',
                           'fixture_gray_speed_crop.jpg')]
    for geom in ((64, 64, 48, 64, 8, 0), (128, 192, 120, 160, 4, 16)):
        got = native_loader.load_batch(paths, *geom, nthreads=nthreads)
        np.testing.assert_array_equal(
            got, native_loader.load_batch_plain(paths, *geom))


# --------------------------------------------------------------------------
# batch-statistics batch norm (TRAIN_BN None / True) on the card


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', [(8, 16, 12, 10), (1, 16)],
                         ids=['conv', 'one_value'])
def test_batch_stats_bn_matches_the_cpu(cuda_device, shape, dtype):
    """The same FrozenBN under TRAIN_BN=None on the card and on the CPU:
    the output (cuDNN's mixed-type batch norm; at one value per channel
    the bias), the pending statistics and the committed running ones."""
    from ursonet_torch.models.resnet import FrozenBN
    rng = np.random.RandomState(3)
    c = shape[1]
    x = torch.from_numpy((rng.randn(*shape) * 3 + 1).astype(np.float32))
    bns = []
    for dev in ('cpu', cuda_device):
        bn = FrozenBN(c, None).to(dev).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
            bn.bias.copy_(torch.from_numpy(rng.randn(c) * 0.1))
        bns.append(bn)
    bns[1].load_state_dict(bns[0].state_dict())
    xs = [x.to(dtype).clone().requires_grad_(True),
          x.to(cuda_device, dtype).requires_grad_(True)]
    ys = [bn(xi) for bn, xi in zip(bns, xs)]
    for y, xi in zip(ys, xs):
        y.float().square().sum().backward()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert ys[1].dtype == dtype and torch.isfinite(ys[1].float()).all()
    torch.testing.assert_close(ys[1].float().cpu(), ys[0].float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(xs[1].grad.float().cpu(), xs[0].grad.float(),
                               rtol=tol, atol=tol)
    for a, b in zip(bns[0].pending, bns[1].pending):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=1e-6)
    assert bns[0].commit() and bns[1].commit()
    for k in ('running_mean', 'running_var'):
        torch.testing.assert_close(getattr(bns[1], k).cpu(),
                                   getattr(bns[0], k), rtol=1e-6, atol=1e-6)


def test_world_of_one_under_nccl_equals_the_step_without_a_mesh(cuda_device,
                                                                tmp_path):
    """A world of one rank under NCCL (a FileStore, device_id set) and its
    1 x 1 DeviceMesh: two train steps through the parallel path (warp_mold,
    the bucketed gradient all-reduce executed) equal the step without a
    mesh bit for bit (cuDNN held deterministic)."""
    from ursonet_torch.parallel import make_mesh, multihost
    cfg = chip_smoke.small_config()
    raw = chip_smoke.make_raw_batch(cfg, 0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    multihost.initialize(f'file://{tmp_path}/store', 1, 0, backend='nccl',
                         device=cuda_device)
    try:
        mesh = make_mesh(data=1, model=1)
        assert mesh.device_mesh is not None
        got = []
        for m in (None, mesh):
            losses, model, _, first, buckets = chip_smoke._par_steps(
                cfg, cuda_device, 0, raw, m)
            got.append((losses, model.state_dict(), buckets))
            assert first is not None
    finally:
        multihost.shutdown()
        torch.backends.cudnn.deterministic = deterministic
    (l0, s0, b0), (l1, s1, b1) = got
    assert (b0, b1) == (0, chip_smoke.PAR_STEPS)
    assert l0 == l1
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_gloo_collectives_take_cuda_tensors(cuda_device, tmp_path):
    """The collectives of the parallel path on CUDA tensors under gloo (a
    world of one): the Megatron pair and the gather by all-reduce keep
    their values and gradients on the card, the bucket all-reduce its
    tensors, gather_rows via the host returns the rows on the CPU."""
    import torch.distributed as dist
    from ursonet_torch.parallel import make_mesh, multihost
    from ursonet_torch.parallel import sharding as sh
    multihost.initialize(f'file://{tmp_path}/store', 1, 0, backend='gloo',
                         device=cuda_device)
    try:
        mesh = make_mesh(data=1, model=1)
        g = mesh.group('model')
        x = torch.randn(4, 6, device=cuda_device, requires_grad=True)
        y = sh.gather_from(sh.reduce_from(sh.copy_to(x, g), g), g, 6, 0, 6)
        y.sum().backward()
        assert y.is_cuda and torch.equal(y, x) and torch.equal(
            x.grad, torch.ones_like(x))
        ts = [torch.randn(3, device=cuda_device), torch.randn(
            2, 2, device=cuda_device)]
        before = [t.clone() for t in ts]
        sh.all_reduce_bucket(ts, g)
        assert all(torch.equal(a, b) for a, b in zip(ts, before))
        rows = sh.gather_rows(x.detach(), g, via_host=True)
        assert not rows.is_cuda and torch.equal(rows, x.detach().cpu())
        t = torch.arange(3.0, device=cuda_device)
        assert torch.equal(sh.replicated(mesh, t), torch.arange(
            3.0, device=cuda_device))
        assert dist.get_backend() == 'gloo'
    finally:
        multihost.shutdown()


# ---------------------------------------------------------------------------
# TRAIN_ACT_Q8: quant_s8 and wgrad_s8 (csrc/actq.cu) against their plain
# versions on the card, bit for bit

from ursonet_torch.models.actq import ConvQ8  # noqa: E402
from ursonet_torch.ops import actq_cuda as aq  # noqa: E402
from ursonet_torch import presets  # noqa: E402
from ursonet_torch.probes import actq_wgrad8 as aw  # noqa: E402

ACTQ_SHAPES = [(4, 64, 32, 40), (3, 5, 7, 9), (2, 3, 70, 90)]
# (N, H, W, Ci, Co, k, stride, pad): odd shapes on wgrad_s8's TMA route
# (ragged Co and Ci blocks, 128- and 256-wide tiles, stride 2 and 3, wide
# rows, the s2d stem's pads), beside the flagship's
ACTQ_ODD = {'ci64_3x3s1': (3, 9, 13, 64, 200, 3, 1, 1),
            'ci256_3x3s1': (2, 7, 9, 256, 200, 3, 1, 1),
            'ci96_3x3s2': (2, 11, 9, 96, 40, 3, 2, 1),
            '1x1s2': (2, 10, 14, 128, 72, 1, 2, 0),
            '1x1s1_view': (3, 7, 9, 192, 64, 1, 1, 0),
            '5x5s3': (2, 20, 23, 64, 64, 5, 3, 2),
            'wide_row': (1, 4, 300, 64, 32, 3, 1, 1),
            's2d_pads': (2, 11, 11, 64, 6, 4, 1, ((2, 1), (2, 1)))}


def _actq_plan(name):
    g = ACTQ_ODD.get(name) or aw.flagship_geometries(4)[name][0]
    n, h, w, ci, co, k, s, pad = g
    return aq.wgrad_plan((n, ci, h, w), co, (k, k), s, aw._pads(pad))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', ACTQ_SHAPES,
                         ids=['aligned', 'ragged', 'stem'])
def test_quant_s8_modes_match_plain(cuda_device, shape, dtype):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=gen) * 3).to(dtype)
    before = dict(aq.mode_launches)
    kernels = dict(aq.kernel_launches)
    q, scale = aq.quant_s8(x.to(cuda_device), 'x')
    pq, pscale = aq.quant_s8_torch(x, 'x')
    assert torch.equal(q.cpu(), pq) and torch.equal(scale.cpu(), pscale)
    r = 27
    qgt, alpha = aq.quant_s8(x.to(cuda_device), 'g', scale, alpha_len=r)
    pqgt, palpha = aq.quant_s8_torch(x, 'g', pscale, alpha_len=r)
    assert torch.equal(qgt.cpu(), pqgt) and torch.equal(alpha.cpu(), palpha)
    dq = aq.quant_s8(q, 'dequant', scale, dtype=dtype)
    assert torch.equal(dq.cpu(), aq.quant_s8_torch(pq, 'dequant', pscale,
                                                   dtype=dtype))
    torch.cuda.synchronize()
    assert {m: aq.mode_launches[m] - before[m] for m in aq.MODES} \
        == {'x': 1, 'g': 1, 'dequant': 1}
    # one kernel launch a call, no fill before it
    assert {k: aq.kernel_launches[k] - kernels[k]
            for k in ('quant_x', 'quant_g', 'dequant')} \
        == {'quant_x': 1, 'quant_g': 1, 'dequant': 1}


# (name, shape, q's storage offset, out's, in elements): per a multiple
# of 16, per % 16 == 8, per odd, a tiny per at N = 70,000 (more samples
# than a grid dimension of 65,535), the flagship's res2 and stem inputs,
# and q and out at unaligned offsets (a head one element a thread, chunks
# that span samples, a tail; every element one a thread where q and out
# cannot both be aligned)
DEQUANT_CASES = [('per16', (4, 64, 32, 40), 0, 0), ('per8', (5, 3, 2, 4), 0, 0),
                 ('odd', (3, 5, 7, 9), 0, 0),
                 ('n70000_per1', (70000, 1), 0, 0),
                 ('n70000_per3', (70000, 3), 0, 0),
                 ('res2', (32, 256, 128, 160), 0, 0),
                 ('stem', (32, 3, 512, 640), 0, 0)] \
    + [(f'q_off{k}', (3, 5, 7, 9), k, 0) for k in (1, 4, 7, 8, 12, 15)] \
    + [(f'out_off{k}', (3, 5, 7, 9), 0, k) for k in (1, 3, 4, 8)] \
    + [('q_off12_out_off4', (3, 5, 7, 9), 12, 4),
       ('q_off12_per16', (4, 64, 32, 40), 12, 0)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', DEQUANT_CASES,
                         ids=[c[0] for c in DEQUANT_CASES])
def test_dequant_matches_plain(cuda_device, case, dtype):
    """quant_s8 'dequant' (out fresh: one kernel launch), or its one
    launch into an out view at the case's offset: dequant_torch's bits,
    every int8 value from -128 to 127 in q, every element of out
    written."""
    name, shape, q_off, out_off = case
    numel = int(np.prod(shape))
    vals = (torch.arange(numel + q_off, device=cuda_device) * 37 + 11) \
        % 256 - 128
    q = vals.to(torch.int8)[q_off:].view(shape)
    gen = torch.Generator().manual_seed(11)
    scale = (torch.rand(shape[0], generator=gen) + 0.01).to(cuda_device)
    want = aq.dequant_torch(q, scale, dtype)
    if out_off == 0:
        before = aq.kernel_launches['dequant']
        got = aq.quant_s8(q, 'dequant', scale, dtype=dtype)
        assert aq.kernel_launches['dequant'] == before + 1
    else:
        buf = torch.full((numel + out_off,), float('nan'), dtype=dtype,
                         device=cuda_device)
        got = buf[out_off:].view(shape)
        lib = aq._lib()
        aq._raise_if(aq._dequant_launch(lib, q, scale, got), lib,
                     'quant_s8')
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('name', list(aw.flagship_geometries(4))
                         + list(ACTQ_ODD))
def test_quant_s8_layouts_match_plain(cuda_device, name, dtype):
    """'x' and 'g' in a wgrad plan's layouts (the TMA route's column
    copies and padded qgt), and 'g' under a data-parallel group (a gloo
    world of one: two launches, the all-reduce between)."""
    import tempfile

    import torch.distributed as dist

    from ursonet_torch.parallel import multihost
    plan = _actq_plan(name)
    gen = torch.Generator().manual_seed(4)
    x = (torch.randn((plan.n, plan.ci, plan.h, plan.w), generator=gen)
         * 3).to(dtype)
    g = (torch.randn((plan.n, plan.co, plan.ho, plan.wo), generator=gen)
         * 2).to(dtype)
    q, scale = aq.quant_s8(x.to(cuda_device), 'x', plan=plan)
    pq, pscale = aq.quant_s8_torch(x, 'x', plan=plan)
    assert q.shape == plan.q_shape
    assert torch.equal(q.cpu(), pq) and torch.equal(scale.cpu(), pscale)
    qgt, alpha = aq.quant_s8(g.to(cuda_device), 'g', scale, alpha_len=9,
                             plan=plan)
    pqgt, palpha = aq.quant_s8_torch(g, 'g', pscale, alpha_len=9, plan=plan)
    assert torch.equal(qgt.cpu(), pqgt) and torch.equal(alpha.cpu(), palpha)
    with tempfile.TemporaryDirectory() as d:
        multihost.initialize(f'file://{d}/store', 1, 0, backend='gloo',
                             device=cuda_device)
        try:
            before = aq.kernel_launches['quant_g_group']
            got = aq.quant_s8(g.to(cuda_device), 'g', scale, alpha_len=9,
                              plan=plan, group=dist.group.WORLD)
            assert aq.kernel_launches['quant_g_group'] == before + 2
        finally:
            multihost.shutdown()
    assert torch.equal(got[0].cpu(), pqgt) and torch.equal(got[1].cpu(),
                                                          palpha)


@pytest.mark.parametrize('route', ['tma', 'ragged'])
@pytest.mark.parametrize('name', list(aw.flagship_geometries(4)))
def test_wgrad_s8_at_flagship_geometries_matches_plain(cuda_device, name,
                                                       route):
    """The flagship's int8-route geometries at batch 4 (the same widths),
    on each route, int32 and with the f32 epilogue."""
    geom, _ = aw.flagship_geometries(4)[name]
    n, h, w, ci, co, k, s, pad = geom
    q, qgt, pads, plan = aw.operands(geom, 1, cuda_device, route)
    before = dict(aq.route_launches)
    got = aq.wgrad_s8(q, qgt, (k, k), s, pads, plan=plan)
    want = aq.wgrad_s8_torch(q, qgt, (k, k), s, pads, plan)
    assert torch.equal(got, want)
    alpha = torch.full((ci * k * k,), 3e-7, device=cuda_device)
    f = aq.wgrad_s8(q, qgt, (k, k), s, pads, alpha, plan=plan)
    assert torch.equal(f, want.float() * alpha.view(1, ci, k, k))
    assert aq.route_launches[route] == before[route] + 2


@pytest.mark.parametrize('name', list(ACTQ_ODD))
def test_wgrad_s8_tma_route_at_odd_shapes(cuda_device, name):
    """The TMA route on shapes whose Co, Ci, K and rows are ragged, its
    int32 sums equal to the plain version's and to the ragged route's."""
    n, h, w, ci, co, k, s, pad = ACTQ_ODD[name]
    q, qgt, pads, plan = aw.operands(ACTQ_ODD[name], 2, cuda_device)
    assert plan.route == 'tma'
    got = aq.wgrad_s8(q, qgt, (k, k), s, pads, plan=plan)
    assert torch.equal(got, aq.wgrad_s8_torch(q, qgt, (k, k), s, pads,
                                              plan))
    rq, rqgt, _, rplan = aw.operands(ACTQ_ODD[name], 2, cuda_device,
                                     'ragged')
    assert torch.equal(got, aq.wgrad_s8(rq, rqgt, (k, k), s, pads,
                                        plan=rplan))


def test_wgrad_s8_check_geometries(cuda_device):
    aw.check(cuda_device)


# chip_smoke.py phase 8g's recipes: config 5's convs from 128x160 and
# 64x80 at its batch of 16 (stage 3 and the strided convs into stage 4:
# TMA plans no other path takes) and config 2's at batch 1 (basic blocks'
# stride-2 3x3 convs; the C = 3 stem on the gather route)
ACTQ_C5 = {k: v for k, v in aw.recipe_geometries(
    presets.benchmark_config(5)).items()
    if '_256x128x160_' in k or 'x64x80_' in k}
ACTQ_C2 = aw.recipe_geometries(chip_smoke.config2())
ACTQ_RECIPES = {**ACTQ_C5, **ACTQ_C2}


@pytest.mark.parametrize('name', list(ACTQ_RECIPES))
def test_wgrad_s8_at_recipe_geometries_matches_plain(cuda_device, name):
    """wgrad_s8 on the route the recipe's conv takes (TMA from 64 input
    channels, the gather + gemm_s8 below), int32 and with the f32
    epilogue, equal to the plain version; one launch a call."""
    geom, _ = ACTQ_RECIPES[name]
    n, h, w, ci, co, k, s, pad = geom
    q, qgt, pads, plan = aw.operands(geom, 6, cuda_device)
    assert plan.route == ('tma' if ci >= 64 else 'ragged')
    before = dict(aq.route_launches)
    got = aq.wgrad_s8(q, qgt, (k, k), s, pads, plan=plan)
    want = aq.wgrad_s8_torch(q, qgt, (k, k), s, pads, plan)
    assert torch.equal(got, want)
    alpha = torch.full((ci * k * k,), 3e-7, device=cuda_device)
    f = aq.wgrad_s8(q, qgt, (k, k), s, pads, alpha, plan=plan)
    assert torch.equal(f, want.float() * alpha.view(1, ci, k, k))
    assert aq.route_launches[plan.route] == before[plan.route] + 2


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('name', list(ACTQ_RECIPES))
def test_quant_s8_at_recipe_geometries_matches_plain(cuda_device, name,
                                                    dtype):
    """'x' and 'g' at the recipe's shapes in its plan's layouts (at batch
    1 a grid barrier over one sample's rows, and the stem's 'g' scale
    over 7 * 7 * 3 columns), equal to the plain version on the card."""
    geom, _ = ACTQ_RECIPES[name]
    n, h, w, ci, co, k, s, pad = geom
    plan = aq.wgrad_plan((n, ci, h, w), co, (k, k), s, aw._pads(pad))
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn((n, ci, h, w), generator=gen) * 3).to(dtype) \
        .to(cuda_device)
    g = (torch.randn((n, co, plan.ho, plan.wo), generator=gen) * 2) \
        .to(dtype).to(cuda_device)
    q, scale = aq.quant_s8(x, 'x', plan=plan)
    pq, pscale = aq.quant_s8_torch(x, 'x', plan=plan)
    assert q.shape == plan.q_shape
    assert torch.equal(q, pq) and torch.equal(scale, pscale)
    r = ci * k * k
    qgt, alpha = aq.quant_s8(g, 'g', scale, alpha_len=r, plan=plan)
    pqgt, palpha = aq.quant_s8_torch(g, 'g', scale, alpha_len=r, plan=plan)
    assert qgt.shape == (co, plan.kp)
    assert torch.equal(qgt, pqgt) and torch.equal(alpha, palpha)


def test_im2col_s8_at_config2_stem_matches_plain(cuda_device):
    """The gather of config 2's stem (1x3x512x640, 7x7/2, pads 3): the
    patch matrix [147, 81920] in one launch, equal to im2col_torch."""
    geom, count = ACTQ_C2['n1_3x512x640_k7s2_co64']
    n, h, w, ci, co, k, s, pad = geom
    plan = aq.wgrad_plan((n, ci, h, w), co, (k, k), s, aw._pads(pad))
    assert plan.route == 'ragged' and count == 1
    gen = torch.Generator().manual_seed(8)
    q = torch.randint(-127, 128, (n, ci, h, w), generator=gen,
                      dtype=torch.int8).to(cuda_device)
    before = aq.kernel_launches['im2col']
    p = aq.im2col_s8(q, plan)
    torch.cuda.synchronize()
    assert aq.kernel_launches['im2col'] == before + 1
    assert p.shape == (147, 81920)
    assert torch.equal(p, aq.im2col_torch(q, (k, k), s, plan.pads, plan))
    with pytest.raises(ValueError):
        aq.im2col_s8(q, aq.wgrad_plan((n, ci, h, w), co, (k, k), s,
                                      plan.pads, route='ragged')._replace(
                                          route='tma'))


@pytest.mark.parametrize('name', list(im2col_mirror.IM2COL_GEOMETRIES))
def test_im2col_s8_at_mirror_geometries_matches_plain(cuda_device, name):
    """The gather at the geometries of its numpy mirror (stride 1 and 2,
    pads, C = 1, 3 and 32, N = 1 and 2, ragged kp), with q 16-byte
    aligned (the bulk copy where the rows allow it) and off by one byte
    (q read directly): equal to im2col_torch."""
    geo = im2col_mirror.IM2COL_GEOMETRIES[name]
    plan = im2col_mirror.plan_for(geo)
    q = torch.from_numpy(im2col_mirror.operands(geo)).to(cuda_device)
    want = aq.im2col_torch(q, (plan.kh, plan.kw), plan.stride, plan.pads,
                           plan)
    buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda_device)
    q1 = buf[1:].view(q.shape)
    q1.copy_(q)
    for x in (q, q1):
        before = aq.kernel_launches['im2col']
        p = aq.im2col_s8(x, plan)
        torch.cuda.synchronize()
        assert aq.kernel_launches['im2col'] == before + 1
        assert torch.equal(p, want)


@pytest.mark.parametrize('ci', [16, 64])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('mode', [True, 'wgrad8'])
def test_convq8_on_the_card_matches_the_cpu(cuda_device, mode, dtype, ci):
    """ConvQ8's saved q, its forward (cuDNN deterministic, TF32 off) and
    dw against the same module on the CPU: q bit for bit; wgrad8's dw bit
    for bit given the same g (the int8 sums are exact; 16 input channels
    take the ragged route, 64 the TMA route); mode True's within 1e-2
    relative (cuDNN sums in another order, in bf16 under bf16)."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    m = ConvQ8(ci, 32, 3, 1, padding=1, mode=mode)
    x = torch.relu(torch.randn((4, ci, 20, 24), generator=gen)).to(dtype)
    g = torch.randn((4, 32, 20, 24), generator=gen).to(dtype)
    outs = {}
    for dev in ('cpu', cuda_device):
        mm = ConvQ8(ci, 32, 3, 1, padding=1, mode=mode).to(dev)
        mm.load_state_dict(m.state_dict())
        xx = x.to(dev).requires_grad_(True)
        mm(xx).backward(g.to(dev))
        outs[str(dev)] = (mm.weight.grad.cpu(), aq.quant_s8(x.to(dev), 'x'))
    (dw_c, (q_c, s_c)), (dw_g, (q_g, s_g)) = outs.values()
    assert torch.equal(q_c, q_g.cpu()) and torch.equal(s_c, s_g.cpu())
    if mode == 'wgrad8':
        # the same q, g and scales: the int32 sums and their rescale agree
        assert torch.equal(dw_g, dw_c)
    else:
        assert float((dw_g - dw_c).norm() / dw_c.norm()) <= 1e-2


@pytest.mark.parametrize('batch', [1, 7])
@pytest.mark.parametrize('kind', ['numpy', 'tensor', 'transposed'])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32],
                         ids=['u8', 'f32'])
def test_staged_copy_gives_the_bytes_of_to(cuda_device, dtype, kind, batch):
    """`utils/staging.py::to_device` through the pinned ring (a float32
    batch of 7 spans several slots) gives `.to(device)`'s bytes, and the
    first of two calls stays whole when the caller overwrites its array
    as soon as the call returns."""
    a = chip_smoke.host_batches(cuda_device, 1, (batch, 512, 640, 3),
                                dtype)[0]
    t = torch.from_numpy(a)
    x = {'numpy': a, 'tensor': t, 'transposed': t.transpose(1, 2)}[kind]
    want = (x if kind != 'numpy' else t).to(cuda_device)
    before = dict(staging.counts)
    got = staging.to_device(x, cuda_device)
    a[:] = 0
    again = staging.to_device(x, cuda_device)
    torch.cuda.synchronize()
    assert chip_smoke._same_bytes(got, want)
    assert not again.any()
    nbytes = a.nbytes
    assert staging.counts['staged'] == before['staged'] + 2
    assert staging.counts['bytes'] == before['bytes'] + 2 * nbytes
    assert staging.counts['chunks'] == before['chunks'] + 2 * len(
        staging.chunk_plan(nbytes))
