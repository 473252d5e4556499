#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ursonet_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. device   the card's name, power limit and the software versions;
              no CUDA device -> exit 1 at once. One line each for the
              facts later slices need: whether h5py and torchvision
              import, and whether native/host_loader.cpp compiles and
              links against libjpeg and libpng (into a temporary dir).
  2. build    nvcc builds every kernel of the port from the checkout, one
              nvcc per source, all at once; ptxas's registers and spills
              and, per kernel, its count of wgmma (IGMMA, HGMMA), TMA
              (UTMALDG, UTMASTG) and ldmatrix (LDSM) instructions; one
              line each for the bf16-epilogue instantiations.
  3. kernels  each kernel against its plain PyTorch version on the card:
              the warp at the train path's shapes, conv_s8 and gemm_s8 at
              the serving path's shapes in every epilogue, in both
              accumulation modes (f32, bf16) and on both of their routes
              (TMA + wgmma, and mma.sync), and at C5's depth with
              accumulators above 2^24, stem_s8 in both input modes and
              both accumulation modes on both of its routes (persistent
              TMA + wgmma, and mma.sync), block_s8 (persistent TMA + wgmma)
              at the probe's shape and on ragged tiles, also against its
              unfused route, mma_rate in every kind on both of its routes
              (wgmma, mma.sync; integers bit-exact).
  4. train    the train step of benchmark_config(3) at full width
              (ResNet-50, 512×640, batch 32) for 5 steps on one seeded
              random batch, then one validation step; losses must be
              finite and fall; the warp kernel must have been launched.
  5. bf16     bf16 training (F16) at full width, 5 steps + 1 validation
     train    step each, losses finite and falling, the warp kernel
              launched: (a) the F16 flagship recipe (benchmark_config(3)
              with F16, batch 32), its step time beside phase 4's;
              (b) benchmark_config(5) (ResNet-101, the 3-keypoint head,
              F16, REMAT, batch 16), its validation outputs decoded by
              the keypoint SVD (the decoded ground-truth keypoints give
              back the poses) and ESA-scored; its gradients under each
              REMAT policy equal to those without (REMAT_CARD_REL); the
              same model and batch under 'narrow' and without REMAT:
              REMAT's peak memory must be below the latter's;
              (c) config 5 served int8 under F16 (calibrate, smooth(0.5),
              bias_correct(passes=1)) at batch 16: gemm_s8 and conv_s8
              launched on their TMA routes, each distinct call and the
              served batch equal to the plain version bit for bit,
              each head within the random-init gate of the float twin,
              detect() returning k1/k2; (d) released_config('speed')
              (ResNet-101, 960×960, 32³ bins): one bf16 forward at
              batch 4, finite heads.
  6. engine   UrsoNet as a user trains it, benchmark_config(3) at full
              width, batch 32, rotation augmentation, in a temporary
              model dir: (a) make_urso_dataset writes 96 train, 32 val and
              32 test PNG frames at the URSO camera's 1280x960 (seconds,
              decode time per PNG row filter, resize time a frame);
              (b) UrsoNet.train, 2 epochs of 4 steps + 1 validation step,
              device-resident: losses finite, metrics.jsonl, 2 snapshots
              and state_latest.msgpack; (c) a fresh engine's resume_state
              gives params, batch_stats and velocity bit for bit, the
              step and epoch, and trains a third epoch; (d) a fourth
              epoch of 12 steps streamed from disk by data_generator +
              Prefetcher, the host loader's images/s alone, the epochs'
              imgs/s side by side;
              the warp launched over (b)-(d); (e) quantize on 8
              training frames, detect on the 32 test frames at 1280x960
              (resampled on the host), gemm_s8 and conv_s8 on their TMA
              routes, each distinct call and the served batch equal to
              the plain version bit for bit, the ESA against the
              frames' own labels (finite, not gated: 24 steps of
              training); (f) save_quantized ->
              load_quantized serves the same bits; (g) check_train_memory's
              estimate beside the measured peak.
  7. artifact the committed flagship int8 artifact served on its golden
              input under F16 and in the f32-epilogue mode: kernel path
              equal to the plain path, within the gate bound of the float
              twin, both int8 kernels launched; drift against the TPU
              goldens and decoded poses printed; its stem rewritten to
              space-to-depth form in memory and served through stem_s8
              gives the same bits.
  8. serve    int8 serving of serving_config() at full width and batch
              (128 × 512×640, seeded random weights; calibrate on 8
              images, smooth(0.5), bias_correct(passes=1), as bench.py)
              through ServingEngine.predict_molded, in the `base` and the
              `host_s2d` variant, under F16 (bench.py's mode) and with
              f32 epilogues: every int8 kernel of the variant launched
              (stem_s8 exactly once per batch), in the served mode,
              outputs within the random-init gate of the float twin,
              decode and ESA score finite; the `s2d` variant equal to
              `host_s2d` bit for bit under F16; every GEMM, every 3x3
              conv and the fused stem of the served model must have
              taken the TMA + wgmma route.
  9. probes   the four kernel-probe entry points at their own shapes
              (ursonet_torch.probes.fused_block, int8_mma, int4_mma,
              stem), their JSON lines printed as they come; the rate
              and stem probes run each kernel on both routes.
 10. numbers  train step and serving time per variant and mode, memory,
              the bf16 float forward at batch 128 (bench.py's
              BENCH_QUANT=0), and each kernel's time in both modes at the
              main paths' shapes beside its plain version,
              the library call and the card's bound (the stem and the
              rate loops on both routes, with the SM clock read while
              they run; the block beside its unfused route, with the SM
              clock); every distinct int8 call of a served batch, and the
              block at the probe's shape, equal to its plain version at
              its full shape.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from ursonet_torch import evaluate, presets, se3, se3t
from ursonet_torch.checkpoint.quant_store import save_quantized
from ursonet_torch.config import Config
from ursonet_torch.data import loader, png
from ursonet_torch.data.loader import keypoint_scale, make_device_preprocess
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Camera, Urso
from ursonet_torch.engine import ServingEngine, UrsoNet
from ursonet_torch.models import quant
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import augment, cuda_build, int8_cuda, warp_cuda
from ursonet_torch.ops.image import resize_geometry, resize_image
from ursonet_torch.probes import fused_block, int4_mma, int8_mma, mma_rate
from ursonet_torch.probes import stem as stem_probe
from ursonet_torch.probes.timing import sm_clock_mhz
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, make_train_step
from ursonet_torch.utils.memory import check_train_memory

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the
# tensor cores, dense int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12

ACC_NAMES = int8_cuda.ACC_NAMES
ACC_DTYPES = {v: k for k, v in ACC_NAMES.items()}
FLAGSHIP_BATCH = 32
CONFIG5_BATCH = presets.benchmark_config(5).BATCH_SIZE
SPEED_BATCH = 4      # released_config('speed')'s bf16 forward
# Each REMAT policy's gradients on the card against those without REMAT
# (remat_grad_rel), relative L2. Measured 0 for every policy at config
# 5's full width, and 0 between two runs without REMAT (NVIDIA H100 80GB
# HBM3, 700 W): cuDNN takes the same algorithms in the recompute and runs
# them deterministically, so the bound is exact.
REMAT_CARD_REL = 0.0
STEPS = 5            # train steps of the main path, then 1 validation step
SERVE_ITERS = 10     # timed serving calls, after 2 warm-up calls
# What this script measured while gemm_s8 and conv_s8 had only their
# mma.sync kernels (the ragged route of today), printed beside this run's
# numbers for the reader: train step, served batch per variant, and the
# kernels' time per served batch.
EARLIER_TRAIN_MS = 132.355
EARLIER_SERVE_MS = {'base': 89.336, 'host_s2d': 76.261}
EARLIER_KERNEL_MS = {'gemm_s8': 55.416, 'gemm_s8_q8_relu': 8.215,
                     'conv_s8': 24.875}
EARLIER_CARD = "[NVIDIA H100 80GB HBM3, 700.00 W]"

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, 'tests', 'data')
ARTIFACT = os.path.join(DATA, 'gate_int8.msgpack')
GOLDEN = os.path.join(DATA, 'gate_golden.npz')


def log(*a):
    print(*a, flush=True)


def machine_facts() -> dict:
    """What the later slices depend on and the port does not need yet:
    whether h5py and torchvision import, and whether the JAX package's
    native host loader (`native/host_loader.cpp`) compiles and links
    against libjpeg, libpng and zlib. The library goes to a temporary
    directory, never into native/."""
    facts = {}
    for mod in ('h5py', 'torchvision'):
        try:
            importlib.import_module(mod)
            facts[mod] = 'imports'
        except ImportError as e:
            facts[mod] = f'does not import ({e})'
    src = os.path.join(ROOT, 'native', 'host_loader.cpp')
    with tempfile.TemporaryDirectory() as d:
        cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', src, '-o',
               os.path.join(d, 'libursonet_host.so'), '-ljpeg', '-lpng',
               '-lz', '-lpthread']
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
            lines = r.stderr.strip().splitlines()
            err = next((ln for ln in lines if 'error' in ln),
                       lines[-1] if lines else '')
            facts['native_loader'] = ('compiles and links' if r.returncode
                                      == 0 else f'fails: {err}')
        except FileNotFoundError:
            facts['native_loader'] = 'fails: no g++'
    return facts


# Instructions counted per kernel in a build's SASS: what a design
# promised (IGMMA / HGMMA for wgmma, UTMALDG / UTMASTG for TMA, LDSM for
# ldmatrix) is in the machine code.
SASS_OPS = ("IGMMA", "HGMMA", "UTMALDG", "UTMASTG", "LDSM")


def sass_counts(lib_path) -> dict:
    """{mangled kernel name: {op: count}} of a built library, from
    `cuobjdump -sass`: instructions whose opcode, before its first '.',
    is one of SASS_OPS. Each template instantiation is its own entry."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts: dict = {}
    kernel = None
    for line in out.splitlines():
        f = re.match(r"\s*Function : (\S+)", line)
        if f:
            kernel = counts.setdefault(f.group(1), dict.fromkeys(SASS_OPS, 0))
            continue
        ins = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                       line)
        if kernel is not None and ins and ins.group(1) in kernel:
            kernel[ins.group(1)] += 1
    return counts


def ptxas_entries(build_log) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from a build's `ptxas -v` output."""
    out, entry, spills = {}, None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)),) + spills
    return out


def demangle(names) -> dict:
    """{mangled: demangled} through c++filt where the toolkit's host has
    it, else the names as they are."""
    names = list(names)
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        res = names
    return dict(zip(names, res)) if len(res) == len(names) \
        else {n: n for n in names}


# The epilogues' instantiations of the bf16 accumulation mode: the last
# template flag of the TMA GEMM / conv kernel, the flag of the stem's.
_BF16_INSTANCE = re.compile(r"(tma_s8_kernel<\d+, (true|false), true>|"
                            r"stem_s8_tma_kernel<true>)")


def log_bf16_instances(builds) -> None:
    """Registers, spills and SASS counts of the bf16 instantiations of
    the epilogues, one line each; a spill is flagged, not fatal."""
    for name, (lib_path, build_log) in builds.items():
        entries = ptxas_entries(build_log)
        sass = sass_counts(lib_path)
        names = demangle(set(entries) | set(sass))
        for mangled, pretty in sorted(names.items(), key=lambda kv: kv[1]):
            m = _BF16_INSTANCE.search(pretty)
            if not m:
                continue
            regs, st, ld = entries.get(mangled, (-1, -1, -1))
            counts = sass.get(mangled, {})
            log(f"  bf16 epilogue {name}: {m.group(0)}: {regs} "
                f"registers, spill stores {st} B, loads {ld} B"
                + (" SPILLS" if st or ld else "") + "; sass "
                + " ".join(f"{op} {n}" for op, n in counts.items() if n))


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


def keypoints_of(q, loc, scale: float):
    """The pose as two virtual keypoints, K1 = R·(s·e3) + loc and
    K2 = R·(s·e2) + loc (`ursonet_tpu/data/urso.py:122-135`), float32."""
    R = se3t.quat2SO3(torch.from_numpy(np.asarray(q, np.float64))).numpy()
    return ((R[:, :, 2] * scale + loc).astype(np.float32),
            (R[:, :, 1] * scale + loc).astype(np.float32))


def make_raw_batch(cfg, seed: int) -> dict:
    """A raw batch as the host loader hands it over: uint8 images at the
    network shape, random_poses, their keypoints (URSO's 3 m) and the
    image meta."""
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
    k1, k2 = keypoints_of(q, loc, keypoint_scale('Urso'))
    return {'images_u8': rng.randint(0, 256, (b, h, w, 3), np.uint8),
            'location': loc, 'quaternion': q, 'gt_k1': k1, 'gt_k2': k2,
            'image_meta': meta}


def flagship_config(f16: bool = False) -> Config:
    cfg = presets.benchmark_config(3)
    cfg.IMAGES_PER_GPU = FLAGSHIP_BATCH
    cfg.F16 = f16
    cfg.update()
    return cfg


def small_serving_config(variant: str = 'base') -> Config:
    """The serving configuration at a size the CPU runs in seconds."""
    cfg = presets.serving_config(batch=2, variant=variant)
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
    cfg.BRANCH_SIZE = 32
    cfg.BOTTLENECK_WIDTH = 16
    cfg.ORI_BINS_PER_DIM = 6
    cfg.update()
    return cfg


def small_config(n: int = 3) -> Config:
    """benchmark_config(n) (3: the flagship recipe, 5: ResNet-101 with
    keypoints, F16 and REMAT) at a size the CPU runs in seconds."""
    cfg = presets.benchmark_config(n)
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
    validation step. Returns the losses, the step fn, the model, the
    preprocess and the raw batch."""
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
    return {'train': metrics, 'val': val, 'step': step, 'raw': raw,
            'model': model, 'pre': pre}


def decode_keypoint_validation(res, cfg, seed: int) -> dict:
    """The keypoint model of `res` in eval on the validation step's batch
    (the same draws), decoded by the keypoint SVD and ESA-scored against
    the pose its ground-truth keypoints decode to. The raw batch's
    keypoints must decode back to its poses (the SVD on the device)."""
    raw, pre, model = res['raw'], res['pre'], res['model']
    gen = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        batch = pre(raw, pre.draw(gen, len(raw['images_u8'])))
        out = model.eval()(batch['images'])
    loc, q = evaluate.decode_results(out, cfg)
    loc_gt, q_gt = evaluate.decode_results(
        {'loc': batch['gt_loc'], 'k1': batch['gt_k1'],
         'k2': batch['gt_k2']}, cfg)
    dev = batch['gt_loc'].device
    _, q_raw = evaluate.decode_results(
        {'loc': torch.from_numpy(raw['location']).to(dev),
         'k1': torch.from_numpy(raw['gt_k1']).to(dev),
         'k2': torch.from_numpy(raw['gt_k2']).to(dev)}, cfg)
    dots = np.abs(np.sum(q_raw * raw['quaternion'], axis=1))
    if not dots.min() > 1 - 1e-5:
        raise RuntimeError("the keypoint decode did not give back the poses "
                           f"of the raw batch: |<q, q_raw>| min {dots.min()}")
    scores = evaluate.esa_scores(loc, q, loc_gt, q_gt)
    if not np.isfinite(scores['esa']).all():
        raise RuntimeError("non-finite ESA scores of the keypoint model")
    return {'scores': scores, 'min_dot': float(dots.min())}


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


def gemm_cases(m, batch=128):
    """(name, (m, k, n)) of gemm_s8: the four 1x1 kinds of each stage
    with `m` rows (None: the rows a served batch of `batch` images gives
    them) and the three head denses with `batch` rows."""
    cases = []
    for s, (h, w, f, out, cin) in STAGES.items():
        rows = batch * h * w if m is None else m
        cases += [(f'{s} 2a first', (rows, cin, f)),
                  (f'{s} 2a', (rows, out, f)), (f'{s} 2c', (rows, f, out)),
                  (f'{s} branch1', (rows, cin, out))]
    return cases + [('loc_dense_0', (batch, 10240, 1024)),
                    ('ori_dense_0', (batch, 10240, 1024)),
                    ('ori_final', (batch, 1024, 13824))]


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


def big_acc_cases(dev, rng, kind, m=1317, batch=2):
    """Operands whose s32 accumulators lie above 2^24: depth 4608 (C5's
    3x3 convs: 3 * 3 * 512) with operands in 100..127, as a GEMM of `m`
    rows or as the C5 3x3 conv at `batch` images; alpha puts y at about
    ±3 (`kind` 'gemm' or 'conv'). Returns [(fn(epilogue, acc_dtype,
    route), plain(epilogue, acc_dtype), name)]."""
    k, n = 4608, 512
    if kind == 'gemm':
        a = torch.from_numpy(rng.randint(100, 128, (m, k)).astype(np.int8))
        shape, name = (m, n), f"gemm_s8 {m}x{k} @ {k}x{n}"
    else:
        a = torch.from_numpy(rng.randint(100, 128, (batch, 16, 20, 512))
                             .astype(np.int8))
        shape, name = (batch, 16, 20, n), f"conv_s8 {batch}x16x20x512 3x3"
    a = a.to(dev)
    w8 = rng.randint(100, 128, (k, n) if kind == 'gemm' else (3, 3, 512, n))
    w = int8_cuda.kernel_layout(w8.astype(np.int8)).to(dev)
    mean_acc = k * 113.5 * 113.5 * (8 / 9 if kind == 'conv' else 1)
    kw = dict(alpha=torch.from_numpy((rng.uniform(0.5, 1.5, n) * 3 / mean_acc)
                                     .astype(np.float32)).to(dev),
              beta=torch.from_numpy(rng.uniform(-4, 0, n).astype(np.float32))
              .to(dev),
              inv_s_out=float(np.float32(1) / np.float32(3.0 / 127)),
              res=s8(rng, shape, dev), res_scale=0.0123)
    pads = ((1, 1), (1, 1))

    def args(ep, acc):
        return {k_: v for k_, v in dict(kw, acc_dtype=acc).items()
                if ep == 'join' or k_ not in ('res', 'res_scale')}
    if kind == 'gemm':
        return [(lambda ep, acc, route: int8_cuda.gemm_s8(
                    a, w, ep, route=route, **args(ep, acc)),
                 lambda ep, acc: int8_cuda.gemm_s8_torch(a, w, ep,
                                                         **args(ep, acc)),
                 name)]
    return [(lambda ep, acc, route: int8_cuda.conv_s8(
                a, w, 1, pads, ep, route=route, **args(ep, acc)),
             lambda ep, acc: int8_cuda.conv_s8_torch(a, w, 1, pads, ep,
                                                     **args(ep, acc)),
             name)]


def stem_args(dev, rng, mode) -> dict:
    """Operands of stem_s8 beside x and w: the flagship's pixel mean, an
    input step near the calibrated one, and epilogue operands that spread
    the requantized values over 0..127 for random operands (K = 192)."""
    mean = np.tile(np.array([123.7, 116.8, 103.9], np.float32), 4)
    alpha = rng.uniform(0.5, 1.5, 64) * 0.6 / (np.sqrt(192) * 128 * 100 / 3)
    return dict(alpha=torch.from_numpy(alpha.astype(np.float32)).to(dev),
                beta=torch.from_numpy(
                    rng.uniform(-1, 1, 64).astype(np.float32)).to(dev),
                inv_s_out=float(np.float32(1) / np.float32(3.0 / 127)),
                mode=mode, mean=mean,
                inv_s_in=float(np.float32(1) / np.float32(1.09)))


def check_int8_kernels(dev, rng, conv_batch=8, gemm_m=1317) -> float:
    """conv_s8 and gemm_s8 against their plain versions (float64
    accumulation) in every epilogue, in both accumulation modes (f32 and
    bf16) and on both routes: the route the wrapper picks for the shape
    (TMA + wgmma for all but the C = 3 stem) and, where that is not it,
    the mma.sync route forced. `gemm_m` rows for the 1x1 shapes: ragged,
    and enough for the 256-wide tile. Then both kernels at C5's depth
    with accumulators above 2^24 (`big_acc_cases`). Any difference
    raises. Returns the largest absolute difference (0.0)."""
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

    def both_routes(name, launch, acc, out_shape, k, picked):
        """`launch(epilogue, route, args)` on the picked route and on the
        forced mma.sync one, every epilogue, both accumulation modes."""
        routes = sorted({picked, 'ragged'}, reverse=True)
        for ep in int8_cuda.EPILOGUES:
            for mode in int8_cuda.ACC_DTYPES:
                args = dict(epilogue_args(dev, rng, out_shape, k, ep),
                            acc_dtype=mode)
                want = int8_cuda.epilogue_torch(acc, ep, **args)
                for route in routes:
                    compare(f"{name} {ep} {ACC_NAMES[mode]} [{route}]",
                            launch(ep, route, args), want)
        return '+'.join(routes)

    for name, (b, h, w, c, kh, kw, n, st, pads) in conv_cases(conv_batch):
        x = s8(rng, (b, h, w, c), dev)
        wt = int8_cuda.kernel_layout(
            rng.randint(-128, 128, (kh, kw, c, n)).astype(np.int8)).to(dev)
        oh, ow = int8_cuda.conv_out_hw(h, w, kh, kw, st, pads)
        acc = int8_cuda.conv_s8_torch(x, wt, st, pads, 's32')
        picked = int8_cuda.conv_route(c, n, kh * kw, x.numel() * 2)
        if picked != ('ragged' if c % 16 else 'tma'):
            raise RuntimeError(f"conv_s8 {name}: route {picked}")
        routes = both_routes(
            f"conv_s8 {name}",
            lambda ep, route, args: int8_cuda.conv_s8(
                x, wt, st, pads, ep, route=route, **args),
            acc, (b, oh, ow, n), kh * kw * c, picked)
        log(f"check conv_s8 {name} {b}x{h}x{w}x{c} -> {n} [{routes}]: "
            f"{len(int8_cuda.EPILOGUES)} epilogues x (f32, bf16) bit-exact")
    for name, (m, k, n) in gemm_cases(gemm_m):
        a = s8(rng, (m, k), dev)
        bt = int8_cuda.kernel_layout(
            rng.randint(-128, 128, (k, n)).astype(np.int8)).to(dev)
        acc = int8_cuda.gemm_s8_torch(a, bt, 's32')
        routes = both_routes(
            f"gemm_s8 {name}",
            lambda ep, route, args: int8_cuda.gemm_s8(
                a, bt, ep, route=route, **args),
            acc, (m, n), k, 'tma')
        log(f"check gemm_s8 {name} {m}x{k} @ {k}x{n} [{routes}]: "
            f"{len(int8_cuda.EPILOGUES)} epilogues x (f32, bf16) bit-exact")
    for kind in ('gemm', 'conv'):
        for fn, plain, name in big_acc_cases(dev, rng, kind):
            for ep in int8_cuda.EPILOGUES:
                for mode in int8_cuda.ACC_DTYPES:
                    want = plain(ep, mode)
                    for route in int8_cuda.ROUTES:
                        compare(f"{name} (acc > 2^24) {ep} {ACC_NAMES[mode]} "
                                f"[{route}]", fn(ep, mode, route), want)
            log(f"check {name} with accumulators above 2^24 [tma+ragged]: "
                f"{len(int8_cuda.EPILOGUES)} epilogues x (f32, bf16) "
                "bit-exact")
    return worst


def _must_equal(name, got, want) -> None:
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise RuntimeError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                           f"{want.dtype}{tuple(want.shape)}")
    diff = int((got != want).sum())
    if diff:
        raise RuntimeError(f"{name}: kernel differs from its plain version "
                           f"in {diff} of {got.numel()} elements")


def stem_operands(dev, rng, b, h2, w2):
    """Packed u8 pixels [b, h2, w2, 12] and an s2d stem kernel."""
    x = torch.from_numpy(rng.randint(0, 256, (b, h2, w2, 12), np.uint8))
    w = int8_cuda.kernel_layout(
        rng.randint(-127, 128, (4, 4, 12, 64)).astype(np.int8))
    return x.to(dev), w.to(dev)


def check_stem_kernel(dev, rng, batch=8) -> float:
    """stem_s8 against its plain version in both input modes and both
    accumulation modes, on the
    route the wrapper picks and on the mma.sync route forced: at the
    flagship shape (256x320 packed pixels), at a shape whose tiles
    overhang every border that the TMA route takes (W2 % 4 == 0), and at
    an odd one that only the mma.sync route takes. Any difference
    raises."""
    for b, h2, w2 in [(batch, 256, 320), (3, 37, 52), (3, 37, 51)]:
        x, w = stem_operands(dev, rng, b, h2, w2)
        picked = int8_cuda.stem_route(w2)
        if picked != ('tma' if w2 % 4 == 0 else 'ragged'):
            raise RuntimeError(f"stem_s8 {b}x{h2}x{w2}: route {picked}")
        routes = sorted({picked, 'ragged'}, reverse=True)
        for mode in int8_cuda.STEM_MODES:
            for acc in int8_cuda.ACC_DTYPES:
                kw = dict(stem_args(dev, rng, mode), acc_dtype=acc)
                want = int8_cuda.stem_s8_torch(x, w, **kw)
                for route in routes:
                    _must_equal(f"stem_s8 {mode} {ACC_NAMES[acc]} "
                                f"{b}x{h2}x{w2}x12 [{route}]",
                                int8_cuda.stem_s8(x, w, route=route, **kw),
                                want)
        log(f"check stem_s8 {b}x{h2}x{w2}x12 -> 64 [{'+'.join(routes)}]: "
            "calibrated and shift128, f32 and bf16 epilogues, bit-exact")
    return 0.0


def check_block_kernel(dev, batch=4) -> float:
    """block_s8 against its plain version and against the unfused route
    at the probe's shape and on images whose ragged tiles touch all four
    borders. Any difference raises."""
    for b, h, w in [(batch, 128, 160), (2, 13, 21), (1, 3, 5)]:
        ops = fused_block.operands(b, h, w, b + h + w, dev)
        got = fused_block.block_s8(*ops)
        _must_equal(f"block_s8 {b}x{h}x{w}", got,
                    fused_block.block_s8_torch(*ops))
        _must_equal(f"block_s8 {b}x{h}x{w} vs unfused", got,
                    fused_block.block_s8_unfused(*ops))
        log(f"check block_s8 {b}x{h}x{w}x256 (64 inside): bit-exact against "
            "the plain version and the unfused route")
    return 0.0


BF16_RATE_TOL = 1e-5   # of the output's largest magnitude


def check_mma_rate(dev, iters=4) -> dict:
    """mma_rate against its plain version at the probes' shapes on both
    routes, in every replica: the integer kinds exact; bf16 within
    BF16_RATE_TOL of the output's largest magnitude (f32 sums in another
    order). Returns the largest absolute error per kind and route."""
    worst = {}
    shapes = sorted(set(int8_mma.SHAPES) | set(int4_mma.SHAPES))
    for kind in mma_rate.KINDS:
        for route in mma_rate.ROUTES:
            worst[kind, route] = 0.0
            for m, n, k in shapes:
                a, b = mma_rate.operands(kind, m, n, k, m + k, dev)
                got = mma_rate.mma_rate(a, b, iters, kind, all_replicas=True,
                                        route=route)
                want = mma_rate.mma_rate_torch(a, b, iters, kind)
                torch.cuda.synchronize()
                err = float((got.double() - want.double()).abs().max())
                worst[kind, route] = max(worst[kind, route], err)
                tol = BF16_RATE_TOL * float(want.abs().max()) \
                    if kind == 'bf16' else 0.0
                if err > tol:
                    raise RuntimeError(f"mma_rate {kind} [{route}] {m}x{n}x"
                                       f"{k}: max abs err {err} over {tol}")
            log(f"check mma_rate {kind} [{route}] iters={iters} at "
                f"{len(shapes)} shapes, every replica: max abs err "
                f"{worst[kind, route]} "
                + ("(tol 1e-5 of the largest output)" if kind == 'bf16'
                   else "(exact)"))
    return worst


# --------------------------------------------------------------------------
# serving path


def rel(a, b) -> float:
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-9))


def serve_artifact(dev, f16: bool = True) -> dict:
    """Serve the committed flagship artifact on its golden input (batch
    2) under F16 (the bf16 epilogues; the mode its goldens were exported
    in) or in the f32-epilogue mode: the kernel path must equal the plain
    path and stay within the gate bound of the float twin
    (tests/test_quant.py's test_gate_artifact_passes); both int8 kernels
    must launch. Drift against the TPU export goldens is printed, not
    asserted: they were computed on a TPU, and TRAINED_GATE_DRIFT holds
    only on the same backend."""
    cfg = presets.serving_config(batch=2, f16=f16)
    mode = 'bf16' if f16 else 'f32'
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
        log(f"artifact [{mode}] {k}: kernel vs plain rel {r_plain:.3e} "
            "(tol 1e-6); "
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
    log(f"artifact [{mode}] launches: {launches}")
    if min(launches['gemm_s8'], launches['conv_s8']) < 1:
        raise RuntimeError(f"the artifact serve missed a kernel: {launches}")
    loc, q = evaluate.decode_results(out, cfg)
    for i in range(len(loc)):
        log(f"artifact [{mode}] pose {i}: loc {np.round(loc[i], 4).tolist()}"
            f" quat {np.round(q[i], 5).tolist()}")
    serve_artifact_s2d(dev, engine, x, f16)
    return launches


def serve_artifact_s2d(dev, engine, x, f16: bool = True) -> None:
    """The same artifact with its stem rewritten to space-to-depth form
    in memory (exact in integers), served from host-packed uint8 pixels
    through stem_s8, against the artifact as it is on the same uint8
    pixels: the same bits, or the difference is printed and raises."""
    qm = engine.qmodel
    base = engine.predict_molded(x)
    cfg = presets.serving_config(batch=2, variant='host_s2d', f16=f16)
    eng2 = ServingEngine(cfg, dev)
    eng2.qmodel = quant.QuantizedModel(cfg, qm.flat, dev)
    eng2.qmodel.act_scales = dict(qm.act_scales)
    eng2.qmodel.bias_delta = dict(qm.bias_delta)
    int8_cuda.reset_counts()
    out = eng2.predict_molded(x)
    torch.cuda.synchronize()
    if int8_cuda.launches['stem_s8'] != 1:
        raise RuntimeError("the s2d artifact did not serve through stem_s8: "
                           f"{int8_cuda.launches}")
    for k in out:
        diff = int((out[k] != base[k]).sum())
        log(f"artifact [{'bf16' if f16 else 'f32'}] {k}: stem rewritten to "
            "s2d and served through stem_s8 "
            f"vs the 7x7 stem: {diff} of {out[k].numel()} values differ, "
            f"max abs {float((out[k] - base[k]).abs().max())}")
        if diff:
            raise RuntimeError(f"artifact {k}: the s2d rewrite changed the "
                               "served outputs")


def serve_flagship(dev, seed: int, variant: str = 'base',
                   f16: bool = True) -> dict:
    """The serving main path at full width and batch in one variant and
    accumulation mode (F16: the bf16 epilogues, bench.py's; else the f32
    ones): seeded random weights, then as bench.py: calibrate on 8
    images, smooth(0.5), bias_correct(passes=1) on the same 8; then one
    served batch of random uint8 images through
    ServingEngine.predict_molded, decoded and ESA-scored against seeded
    poses. Every int8 kernel of the variant must launch (stem_s8 exactly
    once per batch under the s2d variants, never under `base`), every
    launch in the mode, and the outputs stay within the random-init gate
    of the float twin."""
    cfg = presets.serving_config(variant=variant, f16=f16)
    tag = f"{variant} {'bf16' if f16 else 'f32'}"
    rng = np.random.RandomState(seed)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    images = rng.randint(0, 256, (cfg.BATCH_SIZE, h, w, 3), np.uint8)
    loc_gt, q_gt = random_poses(cfg.BATCH_SIZE, rng)
    engine = ServingEngine(cfg, dev,
                           generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    qm = engine.quantize()
    x8 = engine._host_s2d_maybe(images[:8])
    qm.calibrate(x8)
    spread = qm.smooth(0.5)
    t1 = time.perf_counter()
    int8_cuda.reset_counts()
    deltas = qm.bias_correct(x8, passes=1)
    torch.cuda.synchronize()
    log(f"serve [{tag}] quantize: calibrate (8 images) + smooth(0.5) "
        f"{t1 - t0:.1f} s, {len(spread)} groups, worst spread "
        f"{max(spread.values()):.1f}x; bias_correct(passes=1) "
        f"{time.perf_counter() - t1:.1f} s, {len(deltas)} sites, largest "
        f"|delta| {max(deltas.values()):.4f}, launches "
        f"{dict(int8_cuda.launches)}")
    if not all(np.isfinite(v).all() for v in qm.bias_delta.values()):
        raise RuntimeError(f"serve [{tag}]: non-finite bias deltas")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    out = engine.predict_molded(images)
    torch.cuda.synchronize()
    launches, calls = dict(int8_cuda.launches), int8_cuda.calls
    int8_cuda.calls = None
    peak = torch.cuda.max_memory_allocated()
    log(f"serve [{tag}] launches per batch: {launches}")
    want = {'loc': (cfg.BATCH_SIZE, 3),
            'ori': (cfg.BATCH_SIZE, cfg.ORI_BINS_PER_DIM ** 3)}
    for k, shape in want.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            raise RuntimeError(f"serve {k}: {tuple(out[k].shape)}, finite "
                               f"{bool(torch.isfinite(out[k]).all())}")
    want_stem = 0 if variant == 'base' else 1
    if min(launches['gemm_s8'], launches['conv_s8']) < 1 \
            or launches['stem_s8'] != want_stem:
        raise RuntimeError(f"the {variant} serving path must launch gemm_s8 "
                           f"and conv_s8, and stem_s8 {want_stem} times a "
                           f"batch: {launches}")
    check_served_routes(tag, calls)
    modes = Counter(a['acc'] for _, a in calls)
    if set(modes) != {'bf16' if f16 else 'f32'}:
        raise RuntimeError(f"serve [{tag}]: launches in modes {modes}")
    flt = qm.float_twin(x8)
    rels = {k: rel(out[k][:8], flt[k]) for k in flt}
    log(f"serve [{tag}] int8 vs float twin on 8 images (random weights, "
        f"gate {quant.RANDOM_INIT_GATE_REL}): "
        + ", ".join(f"{k} rel {v:.4f}" for k, v in rels.items()))
    if max(rels.values()) >= quant.RANDOM_INIT_GATE_REL:
        raise RuntimeError(f"serve [{tag}]: int8 vs float twin {rels} "
                           "over the random-init gate")
    t0 = time.perf_counter()
    loc, q = evaluate.decode_results(out, cfg)
    scores = evaluate.esa_scores(loc, q, loc_gt, q_gt)
    log(f"serve [{tag}] decode + ESA of {cfg.BATCH_SIZE} poses: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms host wall; mean ESA "
        f"{scores['mean_esa']:.4f}, mean loc err {scores['mean_loc_err']:.3f}"
        f" m, mean ori err {scores['mean_ori_err_deg']:.2f} deg (random "
        "weights)")
    if not np.isfinite(scores['esa']).all():
        raise RuntimeError("non-finite ESA scores")
    return {'engine': engine, 'images': images, 'launches': launches,
            'calls': calls, 'peak': peak, 'out': out}


def serve_keypoints(dev, seed: int) -> dict:
    """benchmark_config(5) served int8 under F16 at its batch of 16, as
    serve_flagship serves the flagship: seeded random weights, calibrate
    on 8 images, smooth(0.5), bias_correct(passes=1); one served batch
    through predict_molded must launch gemm_s8 and conv_s8 in the bf16
    mode on their TMA routes; every distinct call of that batch, on fresh
    operands, and the served batch itself must equal the plain version
    bit for bit; every head must stay within the random-init gate of the
    float twin; detect() must return loc, k1 and k2 per image."""
    cfg = presets.benchmark_config(5)
    tag = 'config5 bf16'
    rng = np.random.RandomState(seed)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    images = rng.randint(0, 256, (cfg.BATCH_SIZE, h, w, 3), np.uint8)
    engine = ServingEngine(cfg, dev,
                           generator=torch.Generator().manual_seed(seed))
    t0 = time.perf_counter()
    qm = engine.quantize()
    qm.calibrate(images[:8])
    qm.smooth(0.5)
    deltas = qm.bias_correct(images[:8], passes=1)
    torch.cuda.synchronize()
    log(f"serve [{tag}] quantize + calibrate (8 images) + smooth(0.5) + "
        f"bias_correct(passes=1): {time.perf_counter() - t0:.1f} s, "
        f"{len(deltas)} sites")
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    out = engine.predict_molded(images)
    torch.cuda.synchronize()
    launches, calls = dict(int8_cuda.launches), int8_cuda.calls
    int8_cuda.calls = None
    log(f"serve [{tag}] launches per batch of {cfg.BATCH_SIZE}: {launches}")
    for k in ('loc', 'k1', 'k2'):
        if tuple(out[k].shape) != (cfg.BATCH_SIZE, 3) \
                or not torch.isfinite(out[k]).all():
            raise RuntimeError(f"serve [{tag}] {k}: {tuple(out[k].shape)}, "
                               f"finite {bool(torch.isfinite(out[k]).all())}")
    if min(launches['gemm_s8'], launches['conv_s8']) < 1:
        raise RuntimeError(f"serve [{tag}] missed an int8 kernel: {launches}")
    check_served_routes(tag, calls)
    modes = Counter(a['acc'] for _, a in calls)
    if set(modes) != {'bf16'}:
        raise RuntimeError(f"serve [{tag}]: launches in modes {modes}")
    check_served_calls(tag, calls, dev, rng)
    plain = qm(images, plain=True)
    torch.cuda.synchronize()
    max_err = 0.0
    for k in out:
        diff = int((out[k] != plain[k]).sum())
        err = float((out[k] - plain[k]).abs().max())
        max_err = max(max_err, err)
        log(f"serve [{tag}] {k}: kernel path vs plain path on the served "
            f"batch: {diff} of {out[k].numel()} values differ, max abs {err}")
        if diff:
            raise RuntimeError(f"serve [{tag}] {k}: the kernel path differs "
                               "from the plain path")
    flt = qm.float_twin(images[:8])
    rels = {k: rel(out[k][:8], flt[k]) for k in flt}
    log(f"serve [{tag}] int8 vs float twin on 8 images (random weights, "
        f"gate {quant.RANDOM_INIT_GATE_REL}): "
        + ", ".join(f"{k} rel {v:.4f}" for k, v in rels.items()))
    if max(rels.values()) >= quant.RANDOM_INIT_GATE_REL:
        raise RuntimeError(f"serve [{tag}]: int8 vs float twin {rels} over "
                           "the random-init gate")
    res = engine.detect(list(images))
    if any(set(r) != {'loc', 'k1', 'k2'} for r in res):
        raise RuntimeError(f"serve [{tag}] detect: {[set(r) for r in res]}")
    loc, q = evaluate.decode_results(out, cfg)
    if not (np.isfinite(loc).all() and np.isfinite(q).all()):
        raise RuntimeError(f"serve [{tag}]: non-finite decoded poses")
    return {'launches': launches, 'calls': calls, 'max_abs_err': max_err}


def check_served_calls(tag, calls, dev, rng) -> None:
    """Every distinct GEMM and conv call of a served batch on fresh
    operands of its shapes, against its plain version: any differing
    element raises."""
    groups = sorted({(name, tuple(sorted(a.items()))) for name, a in calls
                     if name in ('gemm_s8', 'conv_s8')})
    for name, items in groups:
        fn, plain, *_ = _int8_call(name, dict(items), dev, rng)
        _must_equal(f"serve [{tag}] {name} "
                    f"[{' '.join(f'{k}={v}' for k, v in items)}]",
                    fn(), plain())
        del fn, plain
    torch.cuda.empty_cache()
    log(f"serve [{tag}] {len(groups)} distinct int8 calls of the served "
        "batch on fresh operands: each equals its plain version (0 "
        "differing elements)")


def speed_forward(dev, seed: int) -> dict:
    """released_config('speed') (ResNet-101, bottleneck 528, 32³ bins,
    960×960, F16): one bf16 forward of SPEED_BATCH uniform [0, 1) images
    in eval; the heads must be finite, [B,3] and [B,32768]."""
    cfg = presets.released_config('speed')
    cfg.IMAGES_PER_GPU = SPEED_BATCH
    cfg.update()
    model = build_model(cfg, dev, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    x = torch.rand((cfg.BATCH_SIZE, 3, h, w), generator=g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = {'loc': (cfg.BATCH_SIZE, 3),
            'ori': (cfg.BATCH_SIZE, cfg.ORI_BINS_PER_DIM ** 3)}
    for k, shape in want.items():
        v = out[k]
        if tuple(v.shape) != shape or v.dtype != torch.float32 \
                or not torch.isfinite(v).all():
            raise RuntimeError(f"speed forward {k}: {tuple(v.shape)} {v.dtype}"
                               f", finite {bool(torch.isfinite(v).all())}")
    return {'ms': ms, 'shapes': {k: tuple(v.shape) for k, v in out.items()}}


def check_served_routes(variant, calls) -> None:
    """Every GEMM, every 3x3 conv and the fused stem of a served batch
    must have taken the TMA + wgmma route; only the C = 3 stem conv of
    `base` may take the mma.sync one."""
    routes = Counter((name, a['route']) for name, a in calls if 'route' in a)
    log(f"serve [{variant}] routes per batch: "
        + ", ".join(f"{n} {r} x{c}" for (n, r), c in sorted(routes.items())))
    for name, a in calls:
        stem = name == 'conv_s8' and a['c'] == 3
        if not stem and a['route'] != 'tma':
            raise RuntimeError(f"serve [{variant}]: {name} {a} did not take "
                               "the tma route")


def check_device_s2d(dev, served) -> ServingEngine:
    """The `s2d` variant (the device packs the pixels) on the weights,
    scales and bias deltas of the served `host_s2d` model, in its
    accumulation mode: the same bits on one batch. Returns the `s2d`
    engine."""
    host, images = served['engine'], served['images']
    cfg = presets.serving_config(variant='s2d', f16=host.config.F16)
    eng = ServingEngine(cfg, dev)
    eng.qmodel = quant.QuantizedModel(cfg, host.qmodel.flat, dev)
    eng.qmodel.act_scales = dict(host.qmodel.act_scales)
    eng.qmodel.bias_delta = dict(host.qmodel.bias_delta)
    int8_cuda.reset_counts()
    out = eng.predict_molded(images)
    torch.cuda.synchronize()
    if int8_cuda.launches['stem_s8'] != 1:
        raise RuntimeError(f"s2d did not run stem_s8: {int8_cuda.launches}")
    for k, v in served['out'].items():
        diff = int((out[k] != v).sum())
        log(f"serve [s2d] vs [host_s2d] {k}: {diff} of {v.numel()} values "
            "differ")
        if diff:
            raise RuntimeError(f"s2d and host_s2d disagree on {k}")
    return eng


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


def _int8_call(name, a, dev, rng):
    """Fresh operands for one recorded GEMM or conv call: (kernel fn,
    plain fn, library fn or None, operations, bytes), in the call's
    accumulation mode. The bytes count each input once (activations,
    weights, epilogue vectors, residual) and each output once (bf16 for
    the f32 epilogues of the bf16 mode)."""
    ep = a['epilogue']
    acc = ACC_DTYPES[a['acc']]
    ob = int8_cuda.OUT_BYTES[acc][ep]
    if name == 'gemm_s8':
        m, k, n = a['m'], a['k'], a['n']
        x = s8(rng, (m, k), dev)
        wt = int8_cuda.kernel_layout(
            rng.randint(-128, 128, (k, n)).astype(np.int8)).to(dev)
        kw = dict(epilogue_args(dev, rng, (m, n), k, ep), acc_dtype=acc)
        ops = 2 * m * n * k
        nbytes = m * k + k * n + m * n * ob
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
    kw = dict(epilogue_args(dev, rng, (b, oh, ow, n), kh * kw_ * c, ep),
              acc_dtype=acc)
    m = b * oh * ow
    ops = 2 * m * n * kh * kw_ * c
    nbytes = b * h * w * c + kh * kw_ * c * n + m * n * ob
    return (lambda: int8_cuda.conv_s8(x, wt, st, pads, ep, **kw),
            lambda: int8_cuda.conv_s8_torch(x, wt, st, pads, ep, **kw),
            None, ops, nbytes + 8 * n + (m * n if ep == 'join' else 0))


# The 1x1 convs whose ReLU + requantize runs in gemm_s8's epilogue: what
# tools/probe_pallas_c2.py::matmul_requant_kernel computes. A subset of
# gemm_s8's launches, listed apart.
C2_REQUANT = 'gemm_s8_q8_relu'


def time_int8_kernels(calls, dev, rng, card) -> dict:
    """Each int8 kernel's time per served batch: every distinct call of
    one served batch run on fresh operands of its full shapes, held
    against its plain version (any differing element raises: here the
    persistent blocks walk many tiles each), timed (kernel by 10
    launches, plain version by 1, torch._int_mm by 10 for the GEMM) and
    weighted by how often the batch makes it. Bound per call: the
    larger of operations at 1979 TOP/s and bytes at 3.35 TB/s. gemm_s8's
    q8_relu calls are also summed apart, under C2_REQUANT. `routes`
    counts the launches per route (the timed call takes the route the
    recorded one took: the wrapper picks it from the same shapes)."""
    groups = Counter((name, tuple(sorted(a.items()))) for name, a in calls)
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, t_bytes=0.0,
                   t_ops=0.0, launches=0, routes=Counter(),
                   library_ms=0.0 if k.startswith('gemm_s8') else None)
           for k in ('gemm_s8', 'conv_s8', C2_REQUANT)}
    for (name, items), count in sorted(groups.items()):
        a = dict(items)
        fn, plain, lib, ops, nbytes = _int8_call(name, a, dev, rng)
        shape = ' '.join(f'{k}={v}' for k, v in items)
        _must_equal(f"{name} [{shape}]", fn(), plain())
        t = dict(ms=cuda_ms(fn, 10, 1), plain_ms=cuda_ms(plain, 1, 1),
                 t_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                 t_ops=ops / INT8_OP_PER_S * 1e3)
        t['bound_ms'] = max(t['t_bytes'], t['t_ops'])
        if lib is not None:
            t['library_ms'] = cuda_ms(lib, 10, 1)
        log(f"{name} x{count} [{shape}]: 0 differing elements, kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ("
            f"{ops} op, {nbytes} B), " + (f"_int_mm {t['library_ms']:.4f} ms"
                                          if lib is not None else
                                          "no library int8 conv")
            + f", {ops / t['ms'] / 1e9:.1f} TOP/s, "
            f"{nbytes / t['ms'] / 1e6:.1f} GB/s {card}")
        rows = [name] + ([C2_REQUANT] if name == 'gemm_s8'
                         and a['epilogue'] == 'q8_relu' else [])
        for row in rows:
            tot[row]['launches'] += count
            if 'route' in a:
                tot[row]['routes'][a['route']] += count
            for k, v in t.items():
                tot[row][k] += count * v
        del fn, plain, lib
        torch.cuda.empty_cache()
    for t in tot.values():
        t['bound_by'] = 'bytes' if t['t_bytes'] >= t['t_ops'] \
            else 'operations'
    return tot


def time_serving(engine, images, dev) -> dict:
    """Median int8 forward time of a device-resident batch (packed on
    the host first under host_s2d) over SERVE_ITERS calls after 2 warm-up
    calls (CUDA events), and the host wall time of predict_molded from
    host uint8 (reindex and copy included)."""
    x = torch.from_numpy(engine._host_s2d_maybe(images)).to(dev)
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


def time_float_forward(dev, seed: int, card) -> dict:
    """bench.py's BENCH_QUANT=0 forward: the float model of
    serving_config() under F16 (f32 parameters, bf16 compute, f32 head
    outputs) on a device-resident batch of 128 uniform [0, 1) images at
    512x640 in eval, median of SERVE_ITERS calls after 2 warm-up (CUDA
    events). Its outputs must be finite; their distance to the f32
    model's on the same weights and 8 images is printed."""
    cfg = presets.serving_config()
    model = build_model(cfg, dev, torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    x = torch.rand((cfg.BATCH_SIZE, 3, h, w), generator=g, device=dev)
    times = []
    with torch.no_grad():
        out = model(x)
        for i in range(2 + SERVE_ITERS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(x)
            end.record()
            torch.cuda.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        for k, v in out.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise RuntimeError(f"bf16 float forward {k}: {v.dtype}, "
                                   f"finite {bool(torch.isfinite(v).all())}")
        cfg32 = presets.serving_config(f16=False)
        model32 = build_model(cfg32, dev).eval()
        model32.load_state_dict(model.state_dict())
        with quant.no_tf32():
            ref = model32(x[:8])
        rels = {k: rel(out[k][:8], ref[k]) for k in ref}
    ms = statistics.median(times)
    log(f"float forward [bf16] batch {cfg.BATCH_SIZE} 512x640 (bench.py "
        f"BENCH_QUANT=0): median {ms:.3f} ms over {SERVE_ITERS} calls after 2 "
        f"warm-up, {cfg.BATCH_SIZE / ms * 1e3:.2f} imgs/s {card}; vs the f32 "
        "model on 8 images: "
        + ", ".join(f"{k} rel {v:.4f}" for k, v in rels.items()))
    return {'median_ms': ms, 'all_ms': times, 'rel_f32': rels}


def _bound(ops, nbytes, rate) -> dict:
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {'bound_ms': max(t_ops, t_bytes),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def time_block(dev, card, batch=128, h=128, w=160) -> dict:
    """block_s8 at the probe's shape: the kernel, equal to its plain
    version and to the unfused route at this full shape (0 differing
    elements), timed by 20 launches in turns with the unfused route
    (kernel, unfused, kernel; the kernel's time is the mean of its two
    turns), the SM clock read while it runs; the plain version (16
    images at a time: the float64 products are large) once; the bound
    from x read once, out written once and 2 * 139,264 operations a
    pixel. PyTorch has no int8 convolution on the card: no library
    call."""
    ops = fused_block.operands(batch, h, w, 0, dev)

    def plain():
        return torch.cat([fused_block.block_s8_torch(ops[0][i:i + 16],
                                                     *ops[1:])
                          for i in range(0, batch, 16)])

    def kernel():
        return fused_block.block_s8(*ops)

    def unfused():
        return fused_block.block_s8_unfused(*ops)
    want = plain()
    plain_ms = cuda_ms(plain, 1, 0)
    _must_equal(f"block_s8 {batch}x{h}x{w}", kernel(), want)
    _must_equal(f"block_s8 unfused {batch}x{h}x{w}", unfused(), want)
    turns = [cuda_ms(kernel, 20), cuda_ms(unfused, 20), cuda_ms(kernel, 20)]
    ms, unfused_ms = statistics.mean(turns[::2]), turns[1]
    nbytes, nops = fused_block.block_bytes_ops(batch, h, w)
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
               unfused_ms=unfused_ms,
               sm_clock_mhz=sm_clock_mhz(kernel, ms, dev),
               **_bound(nops, nbytes, INT8_OP_PER_S))
    log(f"block_s8 {batch}x{h}x{w}x256: 0 differing elements, kernel "
        f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, SM clock "
        f"{out['sm_clock_mhz']:.0f} MHz), unfused route {unfused_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}: {nbytes} B at 3.35 TB/s, {nops} op at 1979 "
        f"TOP/s), no library int8 conv {card}")
    return out


def time_stem(dev, rng, card, a) -> dict:
    """stem_s8 at the shape, input mode and accumulation mode of a served
    call `a`, on both routes: each equal to its plain version at this full shape (0
    differing elements), timed by 10 launches, the SM clock read while
    it runs; the plain version (32 images at a time: the float64 conv is
    large) once; the bound from the packed pixels read once, the pooled
    output written once, the weights and epilogue vectors, and the conv's
    2 * 192 * 64 operations at every conv pixel. No library call computes
    it. Returns {route: row}."""
    b, h2, w2 = a['b'], a['h2'], a['w2']
    x, wt = stem_operands(dev, rng, b, h2, w2)
    kw = dict(stem_args(dev, rng, a['mode']), acc_dtype=ACC_DTYPES[a['acc']])
    ph, pw = -(-h2 // 2), -(-w2 // 2)

    def plain():
        return torch.cat([int8_cuda.stem_s8_torch(x[i:i + 32], wt, **kw)
                          for i in range(0, b, 32)])
    want = plain()
    plain_ms = cuda_ms(plain, 1, 0)
    ops = 2 * b * h2 * w2 * 192 * 64
    nbytes = b * h2 * w2 * 12 + b * ph * pw * 64 + 192 * 64 + 8 * 64
    rows = {}
    for route in int8_cuda.ROUTES:
        def fn(route=route):
            return int8_cuda.stem_s8(x, wt, route=route, **kw)
        _must_equal(f"stem_s8 [{route}] {b}x{h2}x{w2}x12", fn(), want)
        ms = cuda_ms(fn, 10, 1)
        rows[route] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                           sm_clock_mhz=sm_clock_mhz(fn, ms, dev),
                           **_bound(ops, nbytes, INT8_OP_PER_S))
        r = rows[route]
        log(f"stem_s8 [{route}] {b}x{h2}x{w2}x12 {a['mode']} {a['acc']}: "
            "0 differing "
            f"elements, kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s, SM "
            f"clock {r['sm_clock_mhz']:.0f} MHz), plain {plain_ms:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {ops} op at 1979 "
            f"TOP/s, {nbytes} B at 3.35 TB/s), no library call {card}")
    return rows


def time_mma_rate(kind, route, dev, card, mnk=(1024, 1024, 512),
                  iters=512) -> dict:
    """mma_rate of one kind on one route at the probes' largest shape:
    the kernel, the SM clock read while it runs, its plain version, the
    one PyTorch call that gives the same values (torch._int_mm or a bf16
    matmul, times iters; none for int4) and the bound: replicas * 2mnk *
    iters operations at the card's rate for the type (int4 has no rate
    of its own on this card: the int8 rate), the operands read once and
    every replica's output written once."""
    m, n, k = mnk
    a, b = mma_rate.operands(kind, m, n, k, 0, dev)
    replicas = mma_rate.mma_rate(a, b, 1, kind, all_replicas=True,
                                 route=route).shape[0]
    elt = 2 if kind == 'bf16' else 1
    ops = replicas * 2 * m * n * k * iters
    nbytes = (m * k + k * n) * elt + replicas * m * n * 4
    rate = BF16_FLOP_PER_S if kind == 'bf16' else INT8_OP_PER_S

    def fn():
        return mma_rate.mma_rate(a, b, iters, kind, route=route)
    ms = cuda_ms(fn, 5, 1)
    out = {'ms': ms, 'sm_clock_mhz': sm_clock_mhz(fn, ms, dev),
           'plain_ms': cuda_ms(lambda: mma_rate.mma_rate_torch(
               a, b, iters, kind), 3, 1),
           'library_ms': None, **_bound(ops, nbytes, rate)}
    if kind == 's8':
        out['library_ms'] = cuda_ms(lambda: torch._int_mm(a, b) * iters, 5, 1)
    elif kind == 'bf16':
        out['library_ms'] = cuda_ms(
            lambda: torch.matmul(a, b).float() * iters, 5, 1)
    lib = "null" if out['library_ms'] is None else f"{out['library_ms']:.4f}"
    log(f"mma_rate {kind} [{route}] {m}x{n}x{k} iters {iters} x {replicas} "
        f"replicas: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s, SM clock "
        f"{out['sm_clock_mhz']:.0f} MHz), plain {out['plain_ms']:.4f} ms, "
        f"library (one product, times iters) {lib} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}) {card}")
    return out


def check_warp(dev, rng, K) -> float:
    """The warp kernel against its plain version at the batches of the
    flagship and of config 5 and at a ragged size: nearest exact,
    bilinear within 1e-3; RGB and gray. Returns the max abs error."""
    max_err = 0.0
    for b, c, h, w in [(FLAGSHIP_BATCH, 3, 512, 640),
                       (CONFIG5_BATCH, 3, 512, 640), (3, 3, 100, 130)]:
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


def step_peak(res, seed) -> int:
    """Peak device memory allocated during one train step of `res`, its
    parameters and optimizer state included."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res['step'](res['raw'], torch.Generator().manual_seed(seed + 1))
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def remat_grad_rel(res, seed, remat) -> dict:
    """Per REMAT policy, the largest relative L2 difference over the
    parameters between the gradients of one forward of `res`'s model
    (the sum of the heads' mean squares, on the validation draws' batch)
    with and without the policy. Under False the second run without
    REMAT: the card's own run-to-run floor. The model is left under the
    policy `remat`."""
    raw, pre, model = res['raw'], res['pre'], res['model']
    with torch.no_grad():
        x = pre(raw, pre.draw(torch.Generator().manual_seed(seed + 2),
                              len(raw['images_u8'])))['images']
    params = list(model.parameters())

    def grads(policy):
        model.backbone.set_remat(policy)
        out = model(x)
        loss = sum((v ** 2).mean() for v in out.values())
        return torch.autograd.grad(loss, params)
    ref = grads(False)
    rels = {}
    for policy in (False, True, 'narrow', 'dots'):
        got = grads(policy)
        rels[str(policy)] = max(
            float((g - g0).norm() / g0.norm()) if float(g0.norm()) > 0
            else (0.0 if not g.any() else float('inf'))
            for g, g0 in zip(got, ref))
        del got
    model.backbone.set_remat(remat)
    return rels


def bf16_train(dev, cfg, tag, seed, card) -> dict:
    """Phase 5's train path for `cfg` (F16): STEPS steps + 1 validation
    step with the warp's count read around them, then the step time
    (time_train) and the peak memory of one step. Returns the run."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_counts()
    res = run_main_path(cfg, dev, seed, STEPS)
    torch.cuda.synchronize()
    launches = dict(warp_cuda.launches)
    peak_run = torch.cuda.max_memory_allocated()
    log(f"train [{tag}] losses: "
        + " ".join(f"{m['loss']:.6f}" for m in res['train']))
    log(f"train [{tag}] step 0 metrics: {res['train'][0]}")
    log(f"train [{tag}] step {STEPS - 1} metrics: {res['train'][-1]}")
    log(f"train [{tag}] validation metrics: {res['val']}")
    log(f"train [{tag}] launches: {launches}")
    check_main_path(res)
    if launches['warp_homography'] < 1:
        raise RuntimeError(f"train [{tag}] never launched warp_homography")
    res['launches'] = launches
    res['ms'] = time_train(res, seed)
    res['peak_step'] = step_peak(res, seed)
    b = cfg.BATCH_SIZE
    log(f"train [{tag}] step: median {res['ms']:.3f} ms over 10 steps after "
        f"2 warm-up, {b / res['ms'] * 1e3:.2f} imgs/s, batch {b} "
        f"{cfg.IMAGE_SHAPE[0]}x{cfg.IMAGE_SHAPE[1]} {card}")
    log(f"train [{tag}] peak memory allocated: {peak_run} bytes "
        f"({peak_run / 2**30:.2f} GiB) over the {STEPS} + 1 steps, "
        f"{res['peak_step']} bytes ({res['peak_step'] / 2**30:.2f} GiB) in "
        f"one step {card}")
    return res


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
# phase 6: the engine

# Frames of the engine phase at the URSO camera's 1280×960, and its
# schedule: ENGINE_STEPS train steps + 1 validation step an epoch.
ENGINE_FRAMES = {'train': 96, 'val': 32, 'test': 32}
ENGINE_WH = (1280, 960)
ENGINE_STEPS = 4
ENGINE_CALIB = 8     # training frames the int8 model is calibrated on
ENGINE_LOADER_BATCHES = 3    # batches the host loader is timed over alone
# Steps of the streamed epoch: more than the prefetch queue holds (8),
# so that the epoch runs at the loader's pace and not from a queue that
# filled while the last epoch's checkpoints were written.
ENGINE_STREAM_STEPS = 12


def engine_config(cfg) -> Config:
    cfg.STEPS_PER_EPOCH = ENGINE_STEPS
    cfg.VALIDATION_STEPS = 1
    cfg.update()
    return cfg


def _records(run_dir) -> list:
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def _check_epochs(tag, records, epochs) -> None:
    if [r['epoch'] for r in records] != list(epochs):
        raise RuntimeError(f"engine {tag}: metrics.jsonl epochs "
                           f"{[r['epoch'] for r in records]}")
    for r in records:
        bad = {k: v for k, v in r.items() if not np.isfinite(v)}
        if bad:
            raise RuntimeError(f"engine {tag}: non-finite metrics {bad}")


def _same_tensors(tag, a: dict, b: dict) -> None:
    if a.keys() != b.keys():
        raise RuntimeError(f"engine {tag}: different names")
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    if diff:
        raise RuntimeError(f"engine {tag}: {len(diff)} tensors differ, "
                           f"first {diff[0]}")


def png_filter_times(frame) -> dict:
    """Decode time of `frame` written with each PNG row filter (ms), each
    decode checked against the frame."""
    out = {}
    for ft in range(5):
        data = png.encode_png(frame, ft)
        t0 = time.perf_counter()
        back = png.decode_png(data)
        out[ft] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(back, frame):
            raise RuntimeError(f"PNG filter {ft} did not round-trip")
    return out


def run_engine(cfg, device, root, seed: int = 0, frames=None, wh=ENGINE_WH,
               card: str = '') -> dict:
    """The engine phase: `make_urso_dataset` frames on disk, then
    UrsoNet.train as a user calls it: (b) 2 epochs device-resident,
    (c) a fresh engine resumes the run bit for bit and trains a third,
    (d) a fourth epoch, of ENGINE_STREAM_STEPS steps, streamed from disk
    (data_generator + Prefetcher), (e) quantize on training frames and detect the test
    frames, the served batch and each distinct int8 call held against
    the plain version, decoded and ESA-scored against their own labels,
    (f) the int8 artifact
    saved and served again, (g) the memory estimate. Fails on any
    check; returns the numbers."""
    frames = frames or ENGINE_FRAMES
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    # (a) data
    d = os.path.join(root, 'urso')
    t0 = time.perf_counter()
    make_urso_dataset(d, subsets=tuple(frames), n_per_subset=frames,
                      width=wh[0], height=wh[1], seed=seed)
    out['data_s'] = time.perf_counter() - t0
    ds = {}
    for subset in frames:
        ds[subset] = Urso()
        ds[subset].load_dataset(d, cfg, subset)
    n_frames = sum(frames.values())
    log(f"engine (a) make_urso_dataset: {n_frames} frames "
        f"({', '.join(f'{k} {v}' for k, v in frames.items())}) at "
        f"{wh[0]}x{wh[1]} in {out['data_s']:.1f} s "
        f"({out['data_s'] / n_frames * 1e3:.1f} ms a frame, host)")
    frame = ds['train'].load_image(0)
    t = png_filter_times(frame)
    log(f"engine (a) PNG decode of one {wh[0]}x{wh[1]} frame by row filter "
        f"(host ms): " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        resize_image(frame, min_dim=cfg.IMAGE_MIN_DIM,
                     min_scale=cfg.IMAGE_MIN_SCALE, max_dim=cfg.IMAGE_MAX_DIM,
                     mode=cfg.IMAGE_RESIZE_MODE)
        times.append((time.perf_counter() - t0) * 1e3)
    out['resize_ms'] = statistics.median(times)
    log(f"engine (a) resize_image {wh[0]}x{wh[1]} -> "
        f"{cfg.IMAGE_SHAPE[1]}x{cfg.IMAGE_SHAPE[0]}: median "
        f"{out['resize_ms']:.2f} ms a frame over 5 (host, "
        f"{torch.get_num_threads()} threads)")

    # (b) train, device-resident
    model_dir = os.path.join(root, 'logs')
    if not loader.use_resident(ds['train'], cfg):
        raise RuntimeError("engine: the training frames should be resident "
                           f"(DATA_ON_DEVICE={cfg.DATA_ON_DEVICE!r})")
    eng = UrsoNet('training', cfg, model_dir, device=dev)
    eng.initialize(seed)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_counts()
    lines = []
    eng.train(ds['train'], ds['val'], cfg.LEARNING_RATE, 2,
              log_fn=lines.append)
    sync()
    out['peak'] = torch.cuda.max_memory_allocated() if cuda else 0
    for line in lines:
        log(f"engine (b) {line}")
    records = _records(eng.log_dir)
    _check_epochs('(b)', records, range(2))
    snaps = sorted(f for f in os.listdir(eng.log_dir)
                   if f.startswith('weights_'))
    if len(snaps) != 2 or not os.path.exists(
            os.path.join(eng.log_dir, 'state_latest.msgpack')):
        raise RuntimeError(f"engine (b): run dir holds {snaps}")
    out['resident_imgs_per_s'] = [r['imgs_per_s'] for r in records]

    # (c) resume
    eng2 = UrsoNet('training', cfg, model_dir, device=dev)
    if not eng2.resume_state(eng.log_dir):
        raise RuntimeError("engine (c): no state_latest to resume")
    _same_tensors('(c) params and batch_stats', eng2.model.state_dict(),
                  eng.model.state_dict())
    _same_tensors('(c) velocity', eng2.velocity, eng.velocity)
    if (eng2.step, eng2.epoch) != (eng.step, eng.epoch):
        raise RuntimeError(f"engine (c): step/epoch {eng2.step}/{eng2.epoch}"
                           f" vs {eng.step}/{eng.epoch}")
    log(f"engine (c) resumed {eng.log_dir}: params, batch_stats and velocity "
        f"bit for bit, step {eng2.step}, epoch {eng2.epoch}")
    del eng
    lines = []
    eng2.train(ds['train'], ds['val'], cfg.LEARNING_RATE, 3,
               log_fn=lines.append)
    for line in lines:
        log(f"engine (c) {line}")

    # (d) streaming from disk
    gen = loader.data_generator(ds['train'], cfg, shuffle=True,
                                batch_size=cfg.BATCH_SIZE, seed=seed)
    next(gen)
    t0 = time.perf_counter()
    for _ in range(ENGINE_LOADER_BATCHES):
        next(gen)
    out['loader_imgs_per_s'] = ENGINE_LOADER_BATCHES * cfg.BATCH_SIZE / (
        time.perf_counter() - t0)
    cfg.DATA_ON_DEVICE = False
    cfg.STEPS_PER_EPOCH = ENGINE_STREAM_STEPS
    lines = []
    try:
        eng2.train(ds['train'], ds['val'], cfg.LEARNING_RATE, 4,
                   log_fn=lines.append)
    finally:
        cfg.DATA_ON_DEVICE = 'auto'
        cfg.STEPS_PER_EPOCH = ENGINE_STEPS
    sync()
    out['warp_launches'] = warp_cuda.launches['warp_homography']
    for line in lines:
        log(f"engine (d) {line}")
    records = _records(eng2.log_dir)
    _check_epochs('(d)', records, range(4))
    out['streaming_imgs_per_s'] = records[3]['imgs_per_s']
    log(f"engine (d) host loader alone (decode PNG + resize, one thread, "
        f"{ENGINE_LOADER_BATCHES} batches): {out['loader_imgs_per_s']:.2f} "
        f"images/s; epoch streamed ({ENGINE_STREAM_STEPS} steps, from "
        f"empty prefetch queues) {out['streaming_imgs_per_s']} imgs/s vs "
        f"resident {out['resident_imgs_per_s']} imgs/s (epochs 0-1, "
        f"{ENGINE_STEPS} steps, the first with warm-up) {card}")
    log(f"engine (b)-(d) warp launches: {out['warp_launches']}")
    if cuda and out['warp_launches'] < 1:
        raise RuntimeError("engine: the train path never launched the warp")

    # (e) serve the labelled test frames
    calib = [ds['train'].load_image(i)
             for i in range(min(ENGINE_CALIB, len(ds['train'].image_ids)))]
    t0 = time.perf_counter()
    qm = eng2.quantize(calib)
    log(f"engine (e) quantize on {len(calib)} training frames: "
        f"{time.perf_counter() - t0:.1f} s")
    test = [ds['test'].load_image(i) for i in range(cfg.BATCH_SIZE)]
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    t0 = time.perf_counter()
    res = eng2.detect(test)
    sync()
    out['detect_ms'] = (time.perf_counter() - t0) * 1e3
    out['int8_launches'] = dict(int8_cuda.launches)
    calls, int8_cuda.calls = int8_cuda.calls, None
    log(f"engine (e) detect on {len(test)} {wh[0]}x{wh[1]} frames: "
        f"{out['detect_ms']:.1f} ms host wall (resize, mold, int8 forward), "
        f"launches {out['int8_launches']}")
    if cuda:
        if min(out['int8_launches']['gemm_s8'],
               out['int8_launches']['conv_s8']) < 1:
            raise RuntimeError(f"engine (e): {out['int8_launches']}")
        check_served_routes('engine', calls)
        check_served_calls('engine', calls, dev, np.random.RandomState(seed))
    # the served batch against the plain version, bit for bit
    molded = eng2.mold_inputs(test)[0]
    served = {k: torch.from_numpy(np.stack([r[k] for r in res]))
              for k in res[0]}
    plain = qm(eng2.serving.served_batch(molded), plain=True)
    out['max_abs_err'] = 0.0
    for k, v in served.items():
        p = plain[k].cpu()
        diff = int((v != p).sum())
        err = float((v - p).abs().max())
        out['max_abs_err'] = max(out['max_abs_err'], err)
        log(f"engine (e) {k}: detect's outputs vs the plain path on the "
            f"served batch: {diff} of {v.numel()} values differ, max abs "
            f"{err}")
        if diff:
            raise RuntimeError(f"engine (e) {k}: the kernel path differs "
                               "from the plain path")
    loc, q = evaluate.decode_results(served, cfg)
    loc_gt = np.stack([ds['test'].load_location(i) for i in
                       range(cfg.BATCH_SIZE)]).astype(np.float64)
    q_gt = np.stack([ds['test'].load_quaternion(i) for i in
                     range(cfg.BATCH_SIZE)]).astype(np.float64)
    out['scores'] = evaluate.esa_scores(loc, q, loc_gt, q_gt)
    sc = out['scores']
    log(f"engine (e) ESA against the test frames' labels: mean ESA "
        f"{sc['mean_esa']:.4f}, mean loc err {sc['mean_loc_err']:.3f} m, "
        f"mean ori err {sc['mean_ori_err_deg']:.2f} deg (finite only: "
        f"{eng2.step} train steps)")
    if not np.isfinite(sc['esa']).all():
        raise RuntimeError("engine (e): non-finite ESA scores")

    # (f) the artifact
    path = os.path.join(root, 'int8.msgpack')
    save_quantized(path, qm)
    loaded = ServingEngine(cfg, dev)
    loaded.load_serving_artifact(path)
    want, got = eng2.predict_molded(molded), loaded.predict_molded(molded)
    _same_tensors('(f) artifact outputs', got, want)
    log(f"engine (f) save_quantized -> load_quantized ({os.path.getsize(path)}"
        " bytes) serves the same bits as the model in memory")

    # (g) memory
    out['estimate_gb'] = check_train_memory(cfg, dev, log)
    log(f"engine (g) check_train_memory estimate {out['estimate_gb']:.2f} GB "
        f"vs measured peak {out['peak']} bytes ({out['peak'] / 1e9:.2f} GB) "
        f"over (b) {card}")
    return out


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
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
    for name, fact in machine_facts().items():
        log(f"fact: {name} {fact}")
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
        for kernel, counts in sass_counts(lib_path).items():
            log(f"  sass {kernel}: " + " ".join(
                f"{op} {n}" for op, n in counts.items() if n))
    log_bf16_instances(builds)

    # 3. kernels vs plain
    cfg = flagship_config()
    K = net_intrinsics(cfg)
    rng = np.random.RandomState(args.seed)
    warp_err = check_warp(dev, rng, K)
    t0 = time.perf_counter()
    int8_err = check_int8_kernels(dev, rng)
    stem_err = check_stem_kernel(dev, rng)
    block_err = check_block_kernel(dev)
    rate_err = check_mma_rate(dev)
    log(f"int8 and rate kernel checks: {time.perf_counter() - t0:.1f} s")

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
        f"{FLAGSHIP_BATCH} 512x640 {card} (the same code in an earlier run: "
        f"{EARLIER_TRAIN_MS} ms {EARLIER_CARD})")
    log(f"train peak memory allocated: {peak} bytes "
        f"({peak / 2**30:.2f} GiB) {card}")
    del res
    torch.cuda.empty_cache()

    # 5. bf16 train: (a) the F16 flagship recipe
    t5 = time.perf_counter()
    warp_by_path = {'train_f32': launches['warp_homography']}
    res = bf16_train(dev, flagship_config(f16=True), 'F16 flagship',
                     args.seed, card)
    warp_by_path['train_f16'] = res['launches']['warp_homography']
    log(f"train [F16 flagship] step {res['ms']:.3f} ms vs the f32 step "
        f"{train_ms:.3f} ms (phase 4) in this run, batch {FLAGSHIP_BATCH} "
        f"{card}")
    del res
    # (b) benchmark_config(5): ResNet-101, keypoints, F16, REMAT
    cfg5 = presets.benchmark_config(5)
    res = bf16_train(dev, cfg5, 'config5 REMAT', args.seed, card)
    warp_by_path['train_config5'] = res['launches']['warp_homography']
    dec = decode_keypoint_validation(res, cfg5, args.seed)
    sc = dec['scores']
    log(f"train [config5] validation decoded by the keypoint SVD: mean ESA "
        f"{sc['mean_esa']:.4f}, mean loc err {sc['mean_loc_err']:.3f} m, mean "
        f"ori err {sc['mean_ori_err_deg']:.2f} deg (random weights); raw "
        f"keypoints decode back to their poses, |<q, q_raw>| >= "
        f"{dec['min_dot']:.9f}")
    rels = remat_grad_rel(res, args.seed, cfg5.REMAT)
    log(f"train [config5] gradients of one bf16 forward under each REMAT "
        f"policy vs without REMAT, largest relative L2 over the parameters "
        f"(False: a second run without; tol {REMAT_CARD_REL}): {rels}")
    if not max(rels.values()) <= REMAT_CARD_REL:
        raise RuntimeError(f"REMAT changed the gradients: {rels}")
    ms, peak = {True: res['ms']}, {True: res['peak_step']}
    for policy in ('narrow', False):
        res['model'].backbone.set_remat(policy)
        ms[policy] = time_train(res, args.seed)
        peak[policy] = step_peak(res, args.seed)
    for policy in (True, 'narrow', False):
        log(f"train [config5 REMAT={policy}] step: median "
            f"{ms[policy]:.3f} ms, peak {peak[policy]} bytes "
            f"({peak[policy] / 2**30:.2f} GiB) in one step, batch "
            f"{cfg5.BATCH_SIZE} {card}")
    if not peak[True] < peak[False]:
        raise RuntimeError("REMAT did not lower the peak memory: "
                           f"{peak[True]} vs {peak[False]} bytes")
    del res
    torch.cuda.empty_cache()
    # (c) config 5 served int8 under F16
    served5 = serve_keypoints(dev, args.seed)
    torch.cuda.empty_cache()
    # (d) released_config('speed'): one bf16 forward
    fwd = speed_forward(dev, args.seed)
    log(f"released speed forward [bf16] batch {SPEED_BATCH} 960x960: heads "
        f"{fwd['shapes']}, finite, {fwd['ms']:.1f} ms host wall (first call)"
        f" {card}")
    torch.cuda.empty_cache()
    log(f"bf16 train phase: {time.perf_counter() - t5:.1f} s")

    # 6. the engine: benchmark_config(3) from 1280x960 frames on disk
    t6 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        eng = run_engine(engine_config(flagship_config()), dev, root,
                         args.seed, card=card)
    warp_by_path['engine'] = eng['warp_launches']
    torch.cuda.empty_cache()
    log(f"engine phase: {time.perf_counter() - t6:.1f} s")

    # 7. the committed artifact, under F16 and in the f32-epilogue mode
    for f16 in (True, False):
        serve_artifact(dev, f16)

    # 8. serving path at full width and batch: F16 (bench.py's mode) and
    # the f32-epilogue mode, in the base and host_s2d variants
    int8_launches, calls, serve_ms, stem_call = {}, {}, {}, {}
    for f16 in (True, False):
        mode = 'bf16' if f16 else 'f32'
        for variant in ('base', 'host_s2d'):
            served = serve_flagship(dev, args.seed, variant, f16)
            tag = f"{variant} {mode}"
            if variant == 'host_s2d' and f16:
                t = time_serving(check_device_s2d(dev, served),
                                 served['images'], dev)
                log(f"serve [s2d {mode}] int8 batch "
                    f"{len(served['images'])} 512x640 (the device packs the "
                    f"pixels): median {t['median_ms']:.3f} ms over "
                    f"{SERVE_ITERS} calls after 2 warm-up; predict_molded "
                    f"from host uint8 {t['host_ms']:.3f} ms host wall {card}")
            peak = served['peak']
            t = time_serving(served['engine'], served['images'], dev)
            batch = len(served['images'])
            serve_ms[variant, mode] = t['median_ms']
            earlier = "" if f16 else (
                f" (with the mma.sync kernels alone: "
                f"{EARLIER_SERVE_MS[variant]} ms {EARLIER_CARD})")
            log(f"serve [{tag}] int8 batch {batch} 512x640: median "
                f"{t['median_ms']:.3f} ms over {SERVE_ITERS} calls after 2 "
                f"warm-up (device-resident input), "
                f"{batch / t['median_ms'] * 1e3:.2f} imgs/s {card}{earlier}")
            log(f"serve [{tag}] calls (ms): "
                f"{' '.join(f'{v:.3f}' for v in t['all_ms'])}")
            log(f"serve [{tag}] predict_molded from host uint8 (reindex and "
                f"copy included): median {t['host_ms']:.3f} ms host wall "
                f"over 3, {batch / t['host_ms'] * 1e3:.2f} imgs/s {card}")
            log(f"serve [{tag}] peak memory allocated: {peak} bytes "
                f"({peak / 2**30:.2f} GiB) {card}")
            # gemm_s8 and conv_s8 are counted and timed on the base path,
            # stem_s8 on the host_s2d path
            for name, count in served['launches'].items():
                if (name == 'stem_s8') == (variant == 'host_s2d'):
                    int8_launches[name, mode] = count
            if variant == 'base':
                calls[mode] = served['calls']
            else:
                stem_call[mode] = next(a for n, a in served['calls']
                                       if n == 'stem_s8')
            del served
            torch.cuda.empty_cache()
    for mode in ('bf16', 'f32'):
        log(f"serve [{mode}] base {serve_ms['base', mode]:.3f} ms vs host_s2d "
            f"{serve_ms['host_s2d', mode]:.3f} ms per batch of {batch} in this "
            f"run {card}")
    for variant in ('base', 'host_s2d'):
        log(f"serve [{variant}] bf16 epilogues {serve_ms[variant, 'bf16']:.3f}"
            f" ms vs f32 epilogues {serve_ms[variant, 'f32']:.3f} ms per batch "
            f"in this run {card}")

    # 9. the kernel-probe entry points at their own shapes
    fused_block.reset_counts()
    mma_rate.reset_counts()
    int8_cuda.calls = []
    t0 = time.perf_counter()
    for probe in (fused_block, int8_mma, int4_mma, stem_probe):
        log(f"probe {probe.__name__}:")
        probe.main([])
    torch.cuda.synchronize()
    stem_routes = Counter(a['route'] for n, a in int8_cuda.calls
                          if n == 'stem_s8')
    int8_cuda.calls = None
    probe_launches = {**fused_block.launches, **mma_rate.launches,
                      **{f'stem_s8_{r}': stem_routes[r]
                         for r in int8_cuda.ROUTES}}
    log(f"probes: {time.perf_counter() - t0:.1f} s, launches "
        f"{probe_launches}")
    if min(probe_launches.values()) < 1:
        raise RuntimeError(f"a probe missed its kernel: {probe_launches}")

    # 10. numbers per kernel
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
    int8, stem = {}, {}
    for mode in ('bf16', 'f32'):
        int8[mode] = time_int8_kernels(calls[mode], dev, rng, card)
        int8_launches[C2_REQUANT, mode] = int8[mode][C2_REQUANT]['launches']
        for name, tk in int8[mode].items():
            lib = (f"{tk['library_ms']:.4f}" if tk['library_ms'] is not None
                   else "null")
            earlier = (f", with the mma.sync kernel alone (f32 epilogues) "
                       f"{EARLIER_KERNEL_MS[name]} ms {EARLIER_CARD}"
                       if name in EARLIER_KERNEL_MS and mode == 'f32' else "")
            log(f"{name} [{mode}] per served batch "
                f"({int8_launches[name, mode]} launches, routes "
                f"{dict(tk['routes'])}): kernel {tk['ms']:.4f} ms, plain "
                f"{tk['plain_ms']:.4f} ms, bound {tk['bound_ms']:.4f} ms "
                f"({tk['bound_by']}), library {lib} ms {card}{earlier}")
        stem[mode] = time_stem(dev, rng, card, stem_call[mode])
    float_fwd = time_float_forward(dev, args.seed, card)
    block = time_block(dev, card)
    rates = {(kind, route): time_mma_rate(kind, route, dev, card)
             for kind in mma_rate.KINDS for route in mma_rate.ROUTES}

    keys = ('ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    # stem_s8 and mma_rate have a row per route: the route the main path
    # takes under the kernel's name, the other with the route appended;
    # `kernel_route` names it, `sm_clock_mhz` is the clock while it ran.
    # block_s8's row carries its unfused route's time and the SM clock.
    timed_keys = keys + ('sm_clock_mhz',)
    # The int8 rows are per accumulation mode: under the kernel's name the
    # main path's (bf16, F16), with `_f32acc` appended the f32-epilogue
    # mode's; `acc` names it.
    int8_rows = []
    for mode in ('bf16', 'f32'):
        sfx = '' if mode == 'bf16' else '_f32acc'
        for name, source, replaces in (
                ('gemm_s8', 'int8_gemm.cu',
                 'tools/probe_pallas_int8_matmul.py:45'),
                (C2_REQUANT, 'int8_gemm.cu', 'tools/probe_pallas_c2.py:39'),
                ('conv_s8', 'int8_conv.cu',
                 'tools/probe_pallas_conv3.py:45')):
            int8_rows.append({
                "name": name + sfx, "route": "cuda", "acc": mode,
                "source": f"ursonet_torch/csrc/{source}",
                "replaces": replaces,
                "launches": int8_launches[name, mode] + (
                    eng['int8_launches'].get(name, 0) if mode == 'f32'
                    else 0),
                **({"launches_by_path": {
                    "serve_base": int8_launches[name, mode],
                    "serve_config5": served5['launches'][name]},
                    "max_abs_err_by_path": {
                    "checks": int8_err,
                    "serve_config5": served5['max_abs_err']}}
                   if mode == 'bf16' and name in served5['launches']
                   else {}),
                # the engine serves benchmark_config(3): f32 epilogues
                **({"launches_by_path": {
                    "serve_base": int8_launches[name, mode],
                    "engine": eng['int8_launches'][name]},
                    "max_abs_err_by_path": {
                    "checks": int8_err, "engine": eng['max_abs_err']}}
                   if mode == 'f32' and name in eng['int8_launches']
                   else {}),
                "max_abs_err": (
                    max(int8_err, served5['max_abs_err']) if mode == 'bf16'
                    else max(int8_err, eng['max_abs_err'])
                    if name in eng['int8_launches'] else int8_err),
                **{k: int8[mode][name][k] for k in keys},
                "routes": dict(int8[mode][name]['routes'])})
        int8_rows.append({
            "name": "stem_s8" + sfx, "route": "cuda", "kernel_route": "tma",
            "acc": mode, "source": "ursonet_torch/csrc/int8_stem.cu",
            "replaces": "tools/probe_pallas_stem.py:55",
            "launches": int8_launches['stem_s8', mode],
            "max_abs_err": stem_err,
            **{k: stem[mode]['tma'][k] for k in timed_keys}})
    kernels = [{
        "name": "warp_homography", "route": "cuda",
        "source": "ursonet_torch/csrc/warp.cu",
        "replaces": "ursonet_tpu/ops/warp_pallas.py:56",
        "launches": sum(warp_by_path.values()),
        "launches_by_path": warp_by_path, "max_abs_err": warp_err,
        **{k: on_path[k] for k in keys},
    }] + int8_rows + [{
        "name": "stem_s8_ragged", "route": "cuda", "kernel_route": "ragged",
        "acc": "bf16", "source": "ursonet_torch/csrc/int8_stem.cu",
        "replaces": "tools/probe_pallas_stem.py:55",
        "launches": probe_launches['stem_s8_ragged'],
        "max_abs_err": stem_err,
        **{k: stem['bf16']['ragged'][k] for k in timed_keys},
    }, {
        "name": "block_s8", "route": "cuda",
        "source": "ursonet_torch/csrc/int8_block.cu",
        "replaces": "tools/probe_fused_block.py:60",
        "launches": probe_launches['block_s8'], "max_abs_err": block_err,
        **{k: block[k] for k in timed_keys + ('unfused_ms',)},
    }] + [{
        "name": f"mma_rate_{kind}" + ('' if route == 'wgmma'
                                      else f'_{route}'),
        "route": "cuda", "kernel_route": route,
        "source": "ursonet_torch/csrc/mma_rate.cu",
        "replaces": ("tools/probe_int4_mxu.py:102" if kind == 's4'
                     else "tools/probe_int8_mxu.py:38"),
        "launches": probe_launches[f'mma_rate_{kind}_{route}'],
        "max_abs_err": rate_err[kind, route],
        **{k: rates[kind, route][k] for k in timed_keys},
    } for kind in mma_rate.KINDS for route in mma_rate.ROUTES]
    log(f"float forward [bf16]: {float_fwd['median_ms']:.3f} ms per batch "
        f"of 128; int8 serve [bf16] base {serve_ms['base', 'bf16']:.3f} ms, "
        f"host_s2d {serve_ms['host_s2d', 'bf16']:.3f} ms {card}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to "
        "the kernels line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
