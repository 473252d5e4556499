#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ursonet_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. device   the card's name, power limit and the software versions;
              no CUDA device -> exit 1 at once.
  2. build    nvcc builds every kernel of the port from the checkout, one
              nvcc per source, all at once.
  3. kernels  each kernel against its plain PyTorch version on the card:
              the warp at the train path's shapes, conv_s8 and gemm_s8 at
              the serving path's shapes in every epilogue (bit-exact).
  4. train    the train step of benchmark_config(3) at full width
              (ResNet-50, 512×640, batch 32) for 5 steps on one seeded
              random batch, then one validation step; losses must be
              finite and fall; the warp kernel must have been launched.
  5. artifact the committed flagship int8 artifact served on its golden
              input: kernel path equal to the plain path, within the
              gate bound of the float twin, both int8 kernels launched;
              decoded poses printed.
  6. serve    int8 serving of serving_config() at full width and batch
              (128 × 512×640, seeded random weights, calibrate +
              smooth(0.5)) through ServingEngine.predict_molded; both
              int8 kernels launched; decode and ESA score finite.
  7. numbers  train step and serving time, memory, and each kernel's
              time at the main paths' shapes beside its plain version,
              the library call and the card's bound.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from ursonet_torch import evaluate, presets, se3
from ursonet_torch.config import Config
from ursonet_torch.data.loader import make_device_preprocess
from ursonet_torch.data.urso import Camera
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models import quant
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import augment, cuda_build, int8_cuda, warp_cuda
from ursonet_torch.ops.image import resize_geometry
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, make_train_step

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the
# tensor cores, dense int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12

FLAGSHIP_BATCH = 32
STEPS = 5            # train steps of the main path, then 1 validation step
SERVE_ITERS = 10     # timed serving calls, after 2 warm-up calls

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                    'data')
ARTIFACT = os.path.join(DATA, 'gate_int8.msgpack')
GOLDEN = os.path.join(DATA, 'gate_golden.npz')


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# inputs


def net_intrinsics(cfg) -> np.ndarray:
    """URSO K scaled to the network resolution of `cfg`."""
    cam = Camera()
    _, window, scale = resize_geometry(
        cam.height, cam.width, cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM,
        cfg.IMAGE_MIN_SCALE, cfg.IMAGE_RESIZE_MODE)
    return augment.scaled_intrinsics(cam.K, window, scale)


def homographies(n, K, rng) -> np.ndarray:
    """Half camera rotations of ±10° per axis, half ±85° rolls."""
    Kinv = np.linalg.inv(K)
    Ms = []
    for i in range(n):
        if i % 2 == 0:
            pyr = (rng.rand(3) - 0.5) * 20
        else:
            pyr = np.array([0.0, 0.0, (rng.rand() - 0.5) * 170])
        Ms.append(K @ se3.euler2SO3_left(*pyr) @ Kinv)
    return np.stack(Ms).astype(np.float32)


def random_poses(n, rng):
    """URSO-range camera-frame locations (depth x in 5-40 m, inside the
    field of view) and unit north-hemisphere quaternions, float32."""
    x = rng.uniform(5.0, 40.0, n)
    loc = np.stack([x, rng.uniform(-0.4, 0.4, n) * x,
                    rng.uniform(-0.3, 0.3, n) * x], axis=1)
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.where(q[:, 3:] < 0, -1.0, 1.0)
    return loc.astype(np.float32), q.astype(np.float32)


def make_raw_batch(cfg, seed: int) -> dict:
    """A raw batch as the host loader hands it over: uint8 images at the
    network shape, random_poses and the image meta."""
    rng = np.random.RandomState(seed)
    b = cfg.BATCH_SIZE
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    cam = Camera()
    loc, q = random_poses(b, rng)
    (oh, ow), window, scale = resize_geometry(
        cam.height, cam.width, cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM,
        cfg.IMAGE_MIN_SCALE, cfg.IMAGE_RESIZE_MODE)
    meta = np.array([[i, cam.height, cam.width, 3, oh, ow, 3, *window, scale]
                     for i in range(b)], np.float32)
    return {'images_u8': rng.randint(0, 256, (b, h, w, 3), np.uint8),
            'location': loc, 'quaternion': q, 'image_meta': meta}


def flagship_config() -> Config:
    cfg = presets.benchmark_config(3)
    cfg.IMAGES_PER_GPU = FLAGSHIP_BATCH
    cfg.update()
    return cfg


def small_serving_config() -> Config:
    """The serving configuration at a size the CPU runs in seconds."""
    cfg = presets.serving_config(batch=2)
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
    cfg.BRANCH_SIZE = 32
    cfg.BOTTLENECK_WIDTH = 16
    cfg.ORI_BINS_PER_DIM = 6
    cfg.update()
    return cfg


def small_config() -> Config:
    """The flagship recipe at a size the CPU runs in seconds."""
    cfg = presets.benchmark_config(3)
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
    cfg.BRANCH_SIZE = 32
    cfg.BOTTLENECK_WIDTH = 16
    cfg.ORI_BINS_PER_DIM = 6
    cfg.IMAGES_PER_GPU = 2
    cfg.update()
    return cfg


# --------------------------------------------------------------------------
# main path


def run_main_path(cfg, device, seed: int = 0, steps: int = 5) -> dict:
    """`steps` train steps on one raw batch, each with the same draws (so
    the loss is taken on the same preprocessed batch), then one
    validation step. Returns the losses and the step fns."""
    model = build_model(cfg, device, torch.Generator().manual_seed(seed))
    pre = make_device_preprocess(cfg, device=device)
    step = make_train_step(model, cfg, make_optimizer(cfg),
                           trainable=trainable_mask(model, 'all'),
                           preprocess=pre, device=device)
    eval_step = make_eval_step(model, cfg, preprocess=pre, device=device)
    raw = make_raw_batch(cfg, seed)
    metrics = []
    for _ in range(steps):
        m = step(raw, torch.Generator().manual_seed(seed + 1))
        metrics.append({k: float(v) for k, v in m.items()})
    val = {k: float(v) for k, v in
           eval_step(raw, torch.Generator().manual_seed(seed + 2)).items()}
    return {'train': metrics, 'val': val, 'step': step, 'raw': raw}


def check_main_path(res) -> None:
    losses = [m['loss'] for m in res['train']]
    for m in res['train'] + [res['val']]:
        bad = {k: v for k, v in m.items() if not np.isfinite(v)}
        if bad:
            raise RuntimeError(f"non-finite metrics {bad}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall on the same batch: {losses}")


# --------------------------------------------------------------------------
# int8 kernels at the serving path's shapes

# ResNet-50 stages at 512×640: (H, W, inner width f, output width 4f,
# input width of the stage's first block)
STAGES = {'C2': (128, 160, 64, 256, 64), 'C3': (64, 80, 128, 512, 256),
          'C4': (32, 40, 256, 1024, 512), 'C5': (16, 20, 512, 2048, 1024)}


def conv_cases(batch):
    """(name, (b, h, w, c, kh, kw, n, stride, padding)) of conv_s8."""
    cases = [(f'{s} 3x3', (batch, h, w, f, 3, 3, f, 1, ((1, 1), (1, 1))))
             for s, (h, w, f, _, _) in STAGES.items()]
    cases.append(('stem 7x7/2', (batch, 512, 640, 3, 7, 7, 64, 2,
                                 ((3, 3), (3, 3)))))
    cases.append(('bottleneck 3x3/2', (batch, 16, 20, 2048, 3, 3, 128, 2,
                                       ((0, 1), (0, 1)))))
    return cases


def gemm_cases(m):
    """(name, (m, k, n)) of gemm_s8: the four 1x1 kinds of each stage
    and the three head denses."""
    cases = []
    for s, (_, _, f, out, cin) in STAGES.items():
        cases += [(f'{s} 2a first', (m, cin, f)), (f'{s} 2a', (m, out, f)),
                  (f'{s} 2c', (m, f, out)), (f'{s} branch1', (m, cin, out))]
    return cases + [('loc_dense_0', (m, 10240, 1024)),
                    ('ori_dense_0', (m, 10240, 1024)),
                    ('ori_final', (m, 1024, 13824))]


def s8(rng, shape, dev):
    return torch.from_numpy(
        rng.randint(-128, 128, shape).astype(np.int8)).to(dev)


def epilogue_args(dev, rng, out_shape, k, epilogue) -> dict:
    """Epilogue operands that put y = acc * alpha + beta at about ±3 for
    random s8 operands of depth k, and the requantized values across
    -127..127, so rounding and clipping are both exercised."""
    n = out_shape[-1]
    alpha = rng.uniform(0.5, 1.5, n) * 3.0 / (np.sqrt(k) * 128 * 128 / 3)
    kw = dict(alpha=torch.from_numpy(alpha.astype(np.float32)).to(dev),
              beta=torch.from_numpy(
                  rng.uniform(-1, 1, n).astype(np.float32)).to(dev),
              inv_s_out=float(np.float32(1) / np.float32(3.0 / 127)))
    if epilogue == 'join':
        kw.update(res=s8(rng, out_shape, dev), res_scale=0.0123)
    return kw


def check_int8_kernels(dev, rng, conv_batch=8, gemm_m=128) -> float:
    """conv_s8 and gemm_s8 against their plain versions (float64
    accumulation) in every epilogue; any difference raises. Returns the
    largest absolute difference (0.0)."""
    worst = 0.0

    def compare(name, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise RuntimeError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                               f"{want.dtype}{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max())
        worst = max(worst, err)
        if err != 0.0:
            raise RuntimeError(f"{name}: kernel differs from its plain "
                               f"version, max abs err {err}")

    for name, (b, h, w, c, kh, kw, n, st, pads) in conv_cases(conv_batch):
        x = s8(rng, (b, h, w, c), dev)
        wt = int8_cuda.kernel_layout(
            rng.randint(-128, 128, (kh, kw, c, n)).astype(np.int8)).to(dev)
        oh, ow = int8_cuda.conv_out_hw(h, w, kh, kw, st, pads)
        acc = int8_cuda.conv_s8_torch(x, wt, st, pads, 's32')
        for ep in int8_cuda.EPILOGUES:
            args = epilogue_args(dev, rng, (b, oh, ow, n), kh * kw * c, ep)
            compare(f"conv_s8 {name} {ep}",
                    int8_cuda.conv_s8(x, wt, st, pads, ep, **args),
                    int8_cuda.epilogue_torch(acc, ep, **args))
        log(f"check conv_s8 {name} {b}x{h}x{w}x{c} -> {n}: "
            f"{len(int8_cuda.EPILOGUES)} epilogues bit-exact")
    for name, (m, k, n) in gemm_cases(gemm_m):
        a = s8(rng, (m, k), dev)
        bt = int8_cuda.kernel_layout(
            rng.randint(-128, 128, (k, n)).astype(np.int8)).to(dev)
        acc = int8_cuda.gemm_s8_torch(a, bt, 's32')
        for ep in int8_cuda.EPILOGUES:
            args = epilogue_args(dev, rng, (m, n), k, ep)
            compare(f"gemm_s8 {name} {ep}",
                    int8_cuda.gemm_s8(a, bt, ep, **args),
                    int8_cuda.epilogue_torch(acc, ep, **args))
        log(f"check gemm_s8 {name} {m}x{k} @ {k}x{n}: "
            f"{len(int8_cuda.EPILOGUES)} epilogues bit-exact")
    return worst


# --------------------------------------------------------------------------
# serving path


def rel(a, b) -> float:
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-9))


def serve_artifact(dev) -> dict:
    """Serve the committed flagship artifact on its golden input (batch
    2): the kernel path must equal the plain path and stay within the
    gate bound of the float twin (tests/test_quant.py's
    test_gate_artifact_passes); both int8 kernels must launch. Drift
    against the TPU export goldens is printed, not asserted: they were
    computed in bf16 on a TPU."""
    cfg = presets.serving_config(batch=2)
    g = np.load(GOLDEN)
    engine = ServingEngine(cfg, dev)
    qm = engine.load_serving_artifact(ARTIFACT)
    x = g['golden_in']
    int8_cuda.reset_counts()
    out = qm(x)
    torch.cuda.synchronize()
    launches = dict(int8_cuda.launches)
    plain = qm(x, plain=True)
    flt = qm.float_twin(x)
    bound = max(quant.TRAINED_GATE_REL, 1.25 * float(g['gate_rel']))
    for k in out:
        r_plain, r_twin = rel(out[k], plain[k]), rel(out[k], flt[k])
        log(f"artifact {k}: kernel vs plain rel {r_plain:.3e} (tol 1e-6); "
            f"int8 vs float twin rel {r_twin:.6f} (gate < {bound:.6f}); "
            f"drift vs TPU int8 golden {rel(out[k], g[f'q_{k}']):.6f}; "
            f"float twin vs TPU float golden {rel(flt[k], g[f'f_{k}']):.6f}")
        if not torch.isfinite(out[k]).all():
            raise RuntimeError(f"artifact {k}: non-finite outputs")
        if r_plain > 1e-6:
            raise RuntimeError(f"artifact {k}: kernel path differs from the "
                               f"plain path (rel {r_plain})")
        if not r_twin < bound:
            raise RuntimeError(f"artifact {k}: int8 vs float twin rel "
                               f"{r_twin} over the gate {bound}")
    log(f"artifact launches: {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"the artifact serve missed a kernel: {launches}")
    loc, q = evaluate.decode_results(out, cfg)
    for i in range(len(loc)):
        log(f"artifact pose {i}: loc {np.round(loc[i], 4).tolist()} "
            f"quat {np.round(q[i], 5).tolist()}")
    return launches


def serve_flagship(dev, seed: int) -> dict:
    """The serving main path at full width and batch: seeded random
    weights, calibrate on 8 images + smooth(0.5), then one served batch
    of random uint8 images through ServingEngine.predict_molded, decoded
    and ESA-scored against seeded poses."""
    cfg = presets.serving_config()
    rng = np.random.RandomState(seed)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    images = rng.randint(0, 256, (cfg.BATCH_SIZE, h, w, 3), np.uint8)
    loc_gt, q_gt = random_poses(cfg.BATCH_SIZE, rng)
    engine = ServingEngine(cfg, dev,
                           generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    qm = engine.quantize(list(images[:8]))
    spread = qm.smooth(0.5)
    log(f"quantize: calibrate (8 images) + smooth(0.5) "
        f"{time.perf_counter() - t0:.1f} s, {len(spread)} groups, worst "
        f"spread {max(spread.values()):.1f}x")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    out = engine.predict_molded(images)
    torch.cuda.synchronize()
    launches, calls = dict(int8_cuda.launches), int8_cuda.calls
    int8_cuda.calls = None
    peak = torch.cuda.max_memory_allocated()
    log(f"serve launches per batch: {launches}")
    want = {'loc': (cfg.BATCH_SIZE, 3),
            'ori': (cfg.BATCH_SIZE, cfg.ORI_BINS_PER_DIM ** 3)}
    for k, shape in want.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            raise RuntimeError(f"serve {k}: {tuple(out[k].shape)}, finite "
                               f"{bool(torch.isfinite(out[k]).all())}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"the serving path missed a kernel: {launches}")
    flt = qm.float_twin(images[:8])
    log("serve int8 vs float twin on 8 images (random weights, not gated): "
        + ", ".join(f"{k} rel {rel(out[k][:8], flt[k]):.4f}" for k in flt))
    t0 = time.perf_counter()
    loc, q = evaluate.decode_results(out, cfg)
    scores = evaluate.esa_scores(loc, q, loc_gt, q_gt)
    log(f"decode + ESA of {cfg.BATCH_SIZE} poses: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms host wall; mean ESA "
        f"{scores['mean_esa']:.4f}, mean loc err {scores['mean_loc_err']:.3f}"
        f" m, mean ori err {scores['mean_ori_err_deg']:.2f} deg (random "
        "weights)")
    if not np.isfinite(scores['esa']).all():
        raise RuntimeError("non-finite ESA scores")
    return {'engine': engine, 'images': images, 'launches': launches,
            'calls': calls, 'peak': peak}


# --------------------------------------------------------------------------
# timing


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grid_from_homography(Ms, h, w):
    """F.grid_sample grid (align_corners=True) of the source coordinates."""
    sx, sy = augment._warp_coords(Ms, h, w)
    return torch.stack([sx / (w - 1) * 2 - 1, sy / (h - 1) * 2 - 1], dim=-1)


def time_warp(imgs, Ms, interp) -> dict:
    """Kernel, plain version and F.grid_sample on the same inputs, and the
    card's bound for the work: each input byte read once, each output
    byte written once; ~20 flops per pixel for the coordinate and, for
    bilinear, ~11 per pixel and channel."""
    b, c, h, w = imgs.shape
    plain = (augment.warp_nearest_torch if interp == 'nearest'
             else augment.warp_bilinear_torch)
    grid = grid_from_homography(Ms, h, w)
    out = {
        'ms': cuda_ms(lambda: warp_cuda.warp_cuda(imgs, Ms, interp), 50),
        'plain_ms': cuda_ms(lambda: plain(imgs, Ms), 10),
        'library_ms': cuda_ms(lambda: F.grid_sample(
            imgs, grid, mode=interp, padding_mode='zeros',
            align_corners=True), 20),
        'bytes': 2 * 4 * b * c * h * w + 4 * 9 * b,
        'flops': 20 * b * h * w + (11 * b * c * h * w
                                   if interp == 'bilinear' else 0),
    }
    t_bytes = out['bytes'] / HBM_BYTES_PER_S * 1e3
    t_ops = out['flops'] / F32_FLOP_PER_S * 1e3
    out['bound_ms'] = max(t_bytes, t_ops)
    out['bound_by'] = 'bytes' if t_bytes >= t_ops else 'operations'
    return out


_OUT_BYTES = {'s32': 4, 'f32': 4, 'f32_relu': 4, 'q8_relu': 1, 'q8': 1,
              'join': 1}


def _int8_call(name, a, dev, rng):
    """Fresh operands for one recorded call: (kernel fn, plain fn,
    library fn or None, operations, bytes). The bytes count each input
    once (activations, weights, epilogue vectors, residual) and each
    output once."""
    ep = a['epilogue']
    if name == 'gemm_s8':
        m, k, n = a['m'], a['k'], a['n']
        x = s8(rng, (m, k), dev)
        wt = int8_cuda.kernel_layout(
            rng.randint(-128, 128, (k, n)).astype(np.int8)).to(dev)
        kw = epilogue_args(dev, rng, (m, n), k, ep)
        ops = 2 * m * n * k
        nbytes = m * k + k * n + m * n * _OUT_BYTES[ep]
        return (lambda: int8_cuda.gemm_s8(x, wt, ep, **kw),
                lambda: int8_cuda.gemm_s8_torch(x, wt, ep, **kw),
                lambda: torch._int_mm(x, wt),
                ops, nbytes + 8 * n + (m * n if ep == 'join' else 0))
    b, h, w, c = a['b'], a['h'], a['w'], a['c']
    kh, kw_, n, st, pads = a['kh'], a['kw'], a['n'], a['stride'], a['padding']
    oh, ow = int8_cuda.conv_out_hw(h, w, kh, kw_, st, pads)
    x = s8(rng, (b, h, w, c), dev)
    wt = int8_cuda.kernel_layout(
        rng.randint(-128, 128, (kh, kw_, c, n)).astype(np.int8)).to(dev)
    kw = epilogue_args(dev, rng, (b, oh, ow, n), kh * kw_ * c, ep)
    m = b * oh * ow
    ops = 2 * m * n * kh * kw_ * c
    nbytes = b * h * w * c + kh * kw_ * c * n + m * n * _OUT_BYTES[ep]
    return (lambda: int8_cuda.conv_s8(x, wt, st, pads, ep, **kw),
            lambda: int8_cuda.conv_s8_torch(x, wt, st, pads, ep, **kw),
            None, ops, nbytes + 8 * n + (m * n if ep == 'join' else 0))


def time_int8_kernels(calls, dev, rng, card) -> dict:
    """Each int8 kernel's time per served batch: every distinct call of
    one served batch timed once on fresh operands of its shapes (kernel
    by 10 launches, plain version by 1, torch._int_mm by 10 for the GEMM)
    and weighted by how often the batch makes it. Bound per call: the
    larger of operations at 1979 TOP/s and bytes at 3.35 TB/s."""
    groups = Counter((name, tuple(sorted(a.items()))) for name, a in calls)
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                   t_ops=0.0, library_ms=0.0 if k == 'gemm_s8' else None)
           for k in int8_cuda.launches}
    for (name, items), count in sorted(groups.items()):
        a = dict(items)
        fn, plain, lib, ops, nbytes = _int8_call(name, a, dev, rng)
        t = dict(ms=cuda_ms(fn, 10, 1), plain_ms=cuda_ms(plain, 1, 1),
                 t_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                 t_ops=ops / INT8_OP_PER_S * 1e3)
        t['bound_ms'] = max(t['t_bytes'], t['t_ops'])
        if lib is not None:
            t['library_ms'] = cuda_ms(lib, 10, 1)
        shape = ' '.join(f'{k}={v}' for k, v in items)
        log(f"{name} x{count} [{shape}]: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ("
            f"{ops} op, {nbytes} B), " + (f"_int_mm {t['library_ms']:.4f} ms"
                                          if lib is not None else
                                          "no library int8 conv")
            + f", {ops / t['ms'] / 1e9:.1f} TOP/s {card}")
        for k, v in t.items():
            tot[name][k] += count * v
        del fn, plain, lib
        torch.cuda.empty_cache()
    for t in tot.values():
        t['bound_by'] = 'bytes' if t['t_bytes'] >= t['t_ops'] \
            else 'operations'
    return tot


def time_serving(engine, images, dev) -> dict:
    """Median int8 forward time of a device-resident batch over
    SERVE_ITERS calls after 2 warm-up calls (CUDA events), and the host
    wall time of predict_molded from host uint8 (copy included)."""
    x = torch.from_numpy(images).to(dev)
    qm = engine.qmodel
    times = []
    for i in range(2 + SERVE_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        qm(x)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict_molded(images)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return {'median_ms': statistics.median(times), 'all_ms': times,
            'host_ms': statistics.median(host)}


def check_warp(dev, rng, K) -> float:
    """The warp kernel against its plain version: nearest exact,
    bilinear within 1e-3; RGB and gray. Returns the max abs error."""
    max_err = 0.0
    for b, c, h, w in [(FLAGSHIP_BATCH, 3, 512, 640), (3, 3, 100, 130)]:
        imgs = torch.from_numpy(
            (rng.rand(b, c, h, w) * 255).astype(np.float32)).to(dev)
        Ms = torch.from_numpy(homographies(b, K, rng)).to(dev)
        for interp in ('nearest', 'bilinear'):
            plain = (augment.warp_nearest_torch if interp == 'nearest'
                     else augment.warp_bilinear_torch)
            for gray in (False, True):
                if gray:
                    got = warp_cuda.warp_cuda_gray(imgs, Ms, interp)
                    ref = plain(imgs[:, :1].contiguous(), Ms).expand_as(imgs)
                else:
                    got = warp_cuda.warp_cuda(imgs, Ms, interp)
                    ref = plain(imgs, Ms)
                torch.cuda.synchronize()
                diff = (got - ref).abs()
                err = float(diff.max())
                share = float((diff > 0).float().mean())
                max_err = max(max_err, err)
                name = f"{interp}{' gray' if gray else ''} {b}x{c}x{h}x{w}"
                if interp == 'bilinear':
                    ok = err <= 1e-3
                    log(f"check {name}: max_abs_err={err} (tol 1e-3)")
                else:
                    ok = share == 0.0
                    log(f"check {name}: differing share={share} "
                        f"max_abs_err={err} (tol 0)")
                if not ok:
                    raise RuntimeError(f"warp kernel disagrees: {name}")
    return max_err


def time_train(res, seed) -> float:
    """Median train-step time over 10 steps after 2 warm-up steps."""
    step, raw = res['step'], res['raw']
    gen = torch.Generator()
    times = []
    for i in range(2 + 10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(raw, gen.manual_seed(seed + 3 + i))
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path cannot run",
              file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    log(f"device: {kind} count={torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    log(f"versions: python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda}")
    # Convolutions in TF32 (cuDNN's default), dense matmuls in full f32.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    log("precision: conv TF32 on, matmul TF32 off")

    # 2. build
    t0 = time.perf_counter()
    builds = cuda_build.build_all()
    log(f"build: {len(builds)} sources in parallel, "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (lib_path, build_log) in builds.items():
        log(f"  {name} -> {lib_path.name}")
        for line in build_log.strip().splitlines():
            log(f"    {line}")

    # 3. kernels vs plain
    cfg = flagship_config()
    K = net_intrinsics(cfg)
    rng = np.random.RandomState(args.seed)
    warp_err = check_warp(dev, rng, K)
    t0 = time.perf_counter()
    int8_err = check_int8_kernels(dev, rng)
    log(f"int8 kernel checks: {time.perf_counter() - t0:.1f} s")

    # 4. train path
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_counts()
    res = run_main_path(cfg, dev, args.seed, STEPS)
    torch.cuda.synchronize()
    launches = dict(warp_cuda.launches)
    log("train losses: " + " ".join(f"{m['loss']:.6f}" for m in res['train']))
    log(f"train step 0 metrics: {res['train'][0]}")
    log(f"train step {STEPS - 1} metrics: {res['train'][-1]}")
    log(f"validation metrics: {res['val']}")
    log(f"launches on the train path: {launches}")
    check_main_path(res)
    if launches['warp_homography'] < 1:
        raise RuntimeError("the train path never launched warp_homography")
    peak = torch.cuda.max_memory_allocated()
    train_ms = time_train(res, args.seed)
    log(f"train step: median {train_ms:.3f} ms over 10 steps after 2 "
        f"warm-up, {FLAGSHIP_BATCH / train_ms * 1e3:.2f} imgs/s, batch "
        f"{FLAGSHIP_BATCH} 512x640 {card}")
    log(f"train peak memory allocated: {peak} bytes "
        f"({peak / 2**30:.2f} GiB) {card}")
    del res
    torch.cuda.empty_cache()

    # 5. the committed artifact
    serve_artifact(dev)

    # 6. serving path at full width and batch
    served = serve_flagship(dev, args.seed)
    int8_launches, peak = served['launches'], served['peak']
    t = time_serving(served['engine'], served['images'], dev)
    batch = len(served['images'])
    log(f"serve int8 batch {batch} 512x640: median {t['median_ms']:.3f} ms "
        f"over {SERVE_ITERS} calls after 2 warm-up (device-resident input), "
        f"{batch / t['median_ms'] * 1e3:.2f} imgs/s {card}")
    log(f"serve calls (ms): {' '.join(f'{v:.3f}' for v in t['all_ms'])}")
    log(f"serve predict_molded from host uint8 (copy included): median "
        f"{t['host_ms']:.3f} ms host wall over 3, "
        f"{batch / t['host_ms'] * 1e3:.2f} imgs/s {card}")
    log(f"serve peak memory allocated: {peak} bytes "
        f"({peak / 2**30:.2f} GiB) {card}")
    calls = served['calls']
    del served
    torch.cuda.empty_cache()

    # 7. numbers per kernel
    b, c, h, w = FLAGSHIP_BATCH, 3, 512, 640
    imgs = torch.from_numpy(
        (rng.rand(b, c, h, w) * 255).astype(np.float32)).to(dev)
    Ms = torch.from_numpy(homographies(b, K, rng)).to(dev)
    timed = {i: time_warp(imgs, Ms, i) for i in ('nearest', 'bilinear')}
    for interp, tw in timed.items():
        log(f"warp_homography {interp} {b}x{c}x{h}x{w}: kernel {tw['ms']:.4f}"
            f" ms, plain {tw['plain_ms']:.4f} ms, F.grid_sample "
            f"{tw['library_ms']:.4f} ms, bound {tw['bound_ms']:.4f} ms "
            f"({tw['bound_by']}: {tw['bytes']} B at 3.35 TB/s, {tw['flops']} "
            f"flop at 67 TFLOP/s) {card}")
    on_path = timed[cfg.WARP_INTERPOLATION]
    del imgs, Ms
    int8 = time_int8_kernels(calls, dev, rng, card)
    for name, tk in int8.items():
        lib = (f"{tk['library_ms']:.4f}" if tk['library_ms'] is not None
               else "null")
        log(f"{name} per served batch ({int8_launches[name]} launches): "
            f"kernel {tk['ms']:.4f} ms, plain {tk['plain_ms']:.4f} ms, bound "
            f"{tk['bound_ms']:.4f} ms ({tk['bound_by']}), library {lib} ms "
            f"{card}")

    keys = ('ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    kernels = [{
        "name": "warp_homography", "route": "cuda",
        "source": "ursonet_torch/csrc/warp.cu",
        "replaces": "ursonet_tpu/ops/warp_pallas.py:56",
        "launches": launches['warp_homography'], "max_abs_err": warp_err,
        **{k: on_path[k] for k in keys},
    }, {
        "name": "gemm_s8", "route": "cuda",
        "source": "ursonet_torch/csrc/int8_gemm.cu",
        "replaces": "tools/probe_pallas_int8_matmul.py:45",
        "also_replaces": "tools/probe_pallas_c2.py:39",
        "launches": int8_launches['gemm_s8'], "max_abs_err": int8_err,
        **{k: int8['gemm_s8'][k] for k in keys},
    }, {
        "name": "conv_s8", "route": "cuda",
        "source": "ursonet_torch/csrc/int8_conv.cu",
        "replaces": "tools/probe_pallas_conv3.py:45",
        "launches": int8_launches['conv_s8'], "max_abs_err": int8_err,
        **{k: int8['conv_s8'][k] for k in keys},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
