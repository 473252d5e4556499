#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ursonet_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. device   the card's name, power limit and the software versions;
              no CUDA device -> exit 1 at once.
  2. build    nvcc builds every kernel of the port from the checkout.
  3. kernels  each kernel against its plain PyTorch version on the card.
  4. main     the train step of benchmark_config(3) at full width
              (ResNet-50, 512×640, batch 32) for 5 steps on one
              seeded random batch, then one validation step; losses must
              be finite and fall; every kernel must have been launched.
  5. numbers  step time, memory, and each kernel's time beside its
              plain version, the library call and the card's bound.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ursonet_torch import presets, se3
from ursonet_torch.config import Config
from ursonet_torch.data.loader import make_device_preprocess
from ursonet_torch.data.urso import Camera
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import augment, warp_cuda
from ursonet_torch.ops.image import resize_geometry
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, make_train_step

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FLAGSHIP_BATCH = 32
STEPS = 5            # train steps of the main path, then 1 validation step


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


def make_raw_batch(cfg, seed: int) -> dict:
    """A raw batch as the host loader hands it over: uint8 images at the
    network shape, URSO-range camera-frame locations (depth x in 5-40 m,
    inside the field of view), unit north-hemisphere quaternions and the
    image meta."""
    rng = np.random.RandomState(seed)
    b = cfg.BATCH_SIZE
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    cam = Camera()
    x = rng.uniform(5.0, 40.0, b)
    loc = np.stack([x, rng.uniform(-0.4, 0.4, b) * x,
                    rng.uniform(-0.3, 0.3, b) * x], axis=1)
    q = rng.randn(b, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.where(q[:, 3:] < 0, -1.0, 1.0)
    (oh, ow), window, scale = resize_geometry(
        cam.height, cam.width, cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM,
        cfg.IMAGE_MIN_SCALE, cfg.IMAGE_RESIZE_MODE)
    meta = np.array([[i, cam.height, cam.width, 3, oh, ow, 3, *window, scale]
                     for i in range(b)], np.float32)
    return {'images_u8': rng.randint(0, 256, (b, h, w, 3), np.uint8),
            'location': loc.astype(np.float32),
            'quaternion': q.astype(np.float32),
            'image_meta': meta}


def flagship_config() -> Config:
    cfg = presets.benchmark_config(3)
    cfg.IMAGES_PER_GPU = FLAGSHIP_BATCH
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
    lib_path, build_log = warp_cuda.build()
    warp_cuda.load()
    log(f"build: warp_homography {time.perf_counter() - t0:.1f} s -> "
        f"{lib_path.name}")
    for line in build_log.strip().splitlines():
        log(f"  {line}")

    # 3. kernels vs plain
    cfg = flagship_config()
    K = net_intrinsics(cfg)
    rng = np.random.RandomState(args.seed)
    max_err = 0.0
    cases = [(FLAGSHIP_BATCH, 3, 512, 640), (3, 3, 100, 130)]
    for b, c, h, w in cases:
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

    # 4. main path
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_counts()
    res = run_main_path(cfg, dev, args.seed, STEPS)
    torch.cuda.synchronize()
    launches = dict(warp_cuda.launches)
    log("train losses: " + " ".join(f"{m['loss']:.6f}" for m in res['train']))
    log(f"train step 0 metrics: {res['train'][0]}")
    log(f"train step {STEPS - 1} metrics: {res['train'][-1]}")
    log(f"validation metrics: {res['val']}")
    log(f"launches on the main path: {launches}")
    check_main_path(res)
    if launches['warp_homography'] < 1:
        raise RuntimeError("the main path never launched warp_homography")
    peak = torch.cuda.max_memory_allocated()

    # 5. numbers
    step, raw = res['step'], res['raw']
    gen = torch.Generator()
    times = []
    for i in range(2 + 10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(raw, gen.manual_seed(args.seed + 3 + i))
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    med = statistics.median(times)
    log(f"train step: median {med:.3f} ms over {len(times)} steps after 2 "
        f"warm-up, {FLAGSHIP_BATCH / med * 1e3:.2f} imgs/s, batch "
        f"{FLAGSHIP_BATCH} 512x640 {card}")
    log(f"peak memory allocated: {peak} bytes "
        f"({peak / 2**30:.2f} GiB) {card}")

    b, c, h, w = FLAGSHIP_BATCH, 3, 512, 640
    imgs = torch.from_numpy(
        (rng.rand(b, c, h, w) * 255).astype(np.float32)).to(dev)
    Ms = torch.from_numpy(homographies(b, K, rng)).to(dev)
    timed = {i: time_warp(imgs, Ms, i) for i in ('nearest', 'bilinear')}
    for interp, t in timed.items():
        log(f"warp_homography {interp} {b}x{c}x{h}x{w}: kernel {t['ms']:.4f}"
            f" ms, plain {t['plain_ms']:.4f} ms, F.grid_sample "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} B at 3.35 TB/s, {t['flops']} "
            f"flop at 67 TFLOP/s) {card}")
    on_path = timed[cfg.WARP_INTERPOLATION]

    kernels = [{
        "name": "warp_homography", "route": "cuda",
        "source": "ursonet_torch/csrc/warp.cu",
        "replaces": "ursonet_tpu/ops/warp_pallas.py:56",
        "tpu": "ursonet_tpu/ops/warp_pallas.py::_kernel", "checked": True,
        "launches": launches['warp_homography'], "max_abs_err": max_err,
        **{k: on_path[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                'library_ms')},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
