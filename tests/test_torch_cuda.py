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
        assert ic.launches['stem_s8'] == (0 if v == 'base' else 1)
        # the served stem takes the persistent TMA + wgmma kernel
        assert [a['route'] for n, a in calls if n == 'stem_s8'] == (
            [] if v == 'base' else ['tma'])
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
