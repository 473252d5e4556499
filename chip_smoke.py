#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`ursonet_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:
  1. device   the card's name, power limit and the software versions;
              no CUDA device -> exit 1 at once. One line each for the
              facts later slices need: whether h5py and torchvision
              import, whether native/host_loader.cpp compiles and links
              against libjpeg and libpng (into a temporary dir), the g++
              version, whether zlib.h and zstd.h are there, whether
              libzstd.so.1 loads and where libnvjpeg is.
  2. build    nvcc builds every kernel of the port from the checkout, one
              nvcc per source, all at once; ptxas's registers and spills
              and, per kernel, its count of wgmma (IGMMA, HGMMA), TMA
              (UTMALDG, UTMASTG) and ldmatrix (LDSM) instructions; one
              line each for the bf16-epilogue instantiations.
  3. kernels  each kernel against its plain PyTorch version on the card:
              the warp's unfused mode at the train paths' shapes; its fused
              mode (warp_mold: warp, identity select and mold) against the
              plain chain at the flagship's 32x512x640 u8 batch, config 4's
              4x1x640x960 gray plane, a ragged 3x100x130 that TMA cannot
              address and ragged 3x100x112 u8 and 3x100x100 gray that it
              can (partial tiles on the box path), both interpolations,
              with every third image, none and all left as they are
              (nearest 0 differing elements, bilinear 1e-3);
              conv_s8 and gemm_s8 at
              the serving path's shapes in every epilogue (the joins over
              int8 and float residuals), in both
              accumulation modes (f32, bf16) and on both of their routes
              (TMA + wgmma, and mma.sync), and at C5's depth with
              accumulators above 2^24, stem_s8 in both input modes and
              both accumulation modes on both of its packed routes
              (persistent TMA + wgmma, and mma.sync) and on its 'nhwc'
              route from the raw batch (against its plain version, the
              7x7 chain, and the 'tma' route on the packed pixels),
              block_s8 (persistent TMA + wgmma)
              at the probe's shape and on ragged tiles, also against its
              unfused route, mma_rate in every kind on both of its routes
              (wgmma, mma.sync; integers bit-exact).
  4. train    the train step of benchmark_config(3) at full width
              (ResNet-50, 512×640, batch 32) for 5 steps on one seeded
              random batch, then one validation step; losses must be
              finite and fall; the fused warp (warp_mold) must have been
              launched, and its first call equals the plain chain on the
              same inputs (as on every train path of phases 4-8). The
              calibrated check_train_memory estimate beside the peak of one
              step, here (also at batch 16, which no factor was fitted on)
              and for the F16 flagship and config 5 with and without REMAT
              in phase 5: outside ±25% the run fails.
  5. bf16     bf16 training (F16) at full width, 5 steps + 1 validation
     train    step each, losses finite and falling, the fused warp
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
              step and epoch, and trains a third epoch; (d) the host
              loader's images/s alone on the native route (threaded C++,
              csrc/host_loader.cpp) and on the Python path, beside
              os.cpu_count(); a fourth epoch of 12 steps streamed from
              disk by data_generator + Prefetcher through the native
              route, its first two batches equal to load_batch_plain bit
              for bit, the epochs' imgs/s side by side;
              the fused warp launched over (b)-(d); (e) quantize on 8
              training frames, detect on the 32 test frames at 1280x960
              (resampled on the host), gemm_s8 and conv_s8 on their TMA
              routes, each distinct call and the served batch equal to
              the plain version bit for bit, the ESA against the
              frames' own labels (finite, not gated: 24 steps of
              training); (f) save_quantized ->
              load_quantized serves the same bits; (g) check_train_memory's
              estimate beside the measured peak.
  7. cli      the README's quick start through the port's command line
              (`ursonet_torch.pose_estimator.main`) on phase 6's 1280x960
              PNG frames at the flagship's flags (ResNet-50, 24³ bins,
              bottleneck 128, --image_scale 0.5, rotation augmentation):
              train (1 epoch of 4 steps, batch 32, the fused warp
              launched);
              evaluate in float; evaluate --int8 on the `base` stem and
              with --f16 and the s2d / host-s2d knobs (gemm_s8, conv_s8
              and stem_s8 launched on their TMA routes, the stem's 'nhwc'
              one under `base`, the raw
              heads and the summary equal to those of the same served
              batches through the plain version); export (h5 and the
              int8 artifact), then evaluate --weights <h5>: the raw heads
              of --weights last bit for bit; test (10 overlays) and test
              --image. Each command's seconds and launches, evaluate's
              images/s, the h5 file's bytes and write / read seconds.
  8. speed    benchmark config 4 (SPEED, sim2real, cyclical LR) from
              JPEG frames: (a) make_speed_dataset writes 32 train_no_val,
              8 val, 8 test and 8 real_test gray frames at SPEED's
              1920x1200 through the port's JPEG encoder (one frame's
              encode and decode ms), and one batch of them through the
              native loader equals load_batch_plain; (b) UrsoNet.train
              trains
              benchmark_config(4) at full width (ResNet-50, bottleneck
              128, 16^3 bins, batch 4, 640x960; CLR over 3-update half
              cycles) 2 epochs of 4 steps + 1 validation step in each
              sim2real order: finite losses, every update's learning rate
              the cyclical schedule's, the first train batch's
              channels equal after the preprocess, the fused warp launched
              on the gray plane; (c) the command line's
              `train --dataset speed --sim2real --clr --rot_aug
              --rot_image_aug` (4 steps): the fused gray warp launched; (d)
              `evaluate --dataset speed` (finite ESA) and `submit` in
              float and --int8 (16 rows, test then real_test, each
              sorted; under --int8 gemm_s8 and conv_s8 on their TMA
              routes in the f32-epilogue mode, each distinct call and
              the raw heads of both served sets equal to the plain
              version bit for bit); (e) an
              Adam + CLR run resumed bit for bit (params, mu, nu, nu_max,
              count), then one more epoch on the schedule.
  8b. config2 benchmark config 2 (ResNet-18, bottleneck 32, location and
              quaternion regression, 512x640, batch 1) on phase 6's
              frames through the command line (phase 7's run_cli with
              CONFIG2_FLAGS): train 8 steps streamed through the native
              loader (its first batches equal to load_batch_plain),
              evaluate in float, --int8 with f32 epilogues and with --f16
              and the s2d / host-s2d knobs (gemm_s8, conv_s8 and there
              stem_s8 launched, their routes printed, each distinct
              served call on fresh operands and the raw heads equal to
              the plain version), export and evaluate the h5 (bit for bit),
              test; each command's seconds and evaluate's images/s at
              batch 1; a ResNet-18 step's peak memory beside
              check_train_memory's estimate; one ResNet-34 train step and
              one int8 served batch equal to the plain version.
  8c. trainbn the reference's other train modes, on phase 6's frames:
              (a) the flagship (benchmark_config(3), batch 32) under
              TRAIN_BN=None, f32 and F16: 5 steps + 1 validation step,
              losses finite and falling, every batch norm's running
              statistics moved, the fused warp launched and its first call
              equal to the plain chain, the step time beside phase 4/5's
              frozen-BN step of this run, one step's peak beside
              check_train_memory's (uncalibrated) estimate, not gated;
              (b) config 5 (ResNet-101, keypoints, F16, batch 16) under
              TRAIN_BN=None: one step with REMAT and one without from the
              same weights and batch, the running statistics equal bit
              for bit; (c) config 2 under TRAIN_BN=True at batch 1: the
              head BNs at one value per channel, finite; (d) (a)'s f32
              model quantized on 8 frames and served at batch 32: gemm_s8
              and conv_s8 on their TMA routes, each distinct call and the
              served heads equal to the plain version bit for bit; (e) the
              command line's `train --host_augment` at the flagship's
              flags (4 steps, batch 32): finite losses, the warp launched
              0 times, the host-parity generator's images/s alone beside
              the step's and the epoch's; (f) DEBUG_NANS: a NaN in a
              batch raises FloatingPointError naming the step.
  8d. knobs   serving under the knobs bench.py reads, the flagship at
              full width (512x640, batch 128, seeded random weights, each
              model calibrated on 8 images and smoothed): QUANT_S8_JOIN
              (base F16 with the one bias_correct, host_s2d, base with f32
              epilogues: join_s8 on gemm_s8), the float residual join
              (the shortcut requant sites dropped: bf16 and f32
              residuals; under QUANT_S8_JOIN f32_sum), QUANT_BF16_STEM
              (base, s2d: no stem kernel), QUANT_FLOAT_CLS_FINAL and
              QUANT_FLOAT_REG_HEAD, beside the default F16 base and
              host_s2d batches; config 2 (ResNet-18, batch 1) under
              QUANT_S8_JOIN (join_s8 on conv_s8) and the head knobs; the
              flagship pruned by `python -m ursonet_torch.prune_inner` to
              INNER_WIDTH_MULT 0.5 (every call on the TMA route) and 0.6
              (the 40- and 152-wide ones on mma.sync), served; two F16
              train steps at 0.5 from the pruned weights (batch 32,
              warp_mold launched, its first call equal to the plain
              chain). For every served batch: every call on the route its
              shapes give it, each distinct gemm_s8 / conv_s8 / stem_s8
              call not seen before on fresh operands and 8 images served
              whole equal to the plain version bit for bit, within the
              random-init gate of the float twin; the batch's median of
              10 beside the default F16 base of the same run, and the
              joins launched by epilogue and residual type.
  8e. orbax  the Orbax checkpoint store (CHECKPOINT_FORMAT='orbax') on
              phase 6's frames: the flagship (benchmark_config(3), batch
              32, 512x640, rotation on) trained 1 epoch of 2 steps (the
              fused warp launched, its first call equal to the plain
              chain), the state directory's bytes and its write and read
              seconds; a fresh engine's resume_state bit for bit (params,
              batch_stats, velocity, step, epoch) and its next epoch equal
              to the uninterrupted engine's bit for bit (cuDNN held to
              deterministic algorithms in this phase); the second
              snapshot (find_last) loaded by an inference engine,
              quantized on 8 frames and a batch of 32 served (gemm_s8 and
              conv_s8 on their TMA routes, each distinct call and the heads
              equal to the plain version bit for bit); the committed
              JAX-written fixture (tests/data/orbax_fixture.orbax) read to
              its seeded arrays; the zstd decoder's MB/s on the fixture
              and on the state. zstd.cpp is built by g++ from the
              checkout; a failed build or read fails the run.
  8f. parallel the (data, model) mesh over torch.distributed ranks
              (`run_parallel`): (a) a world of one in this process under
              NCCL (a FileStore, device_id set) and its 1 x 1
              DeviceMesh: two flagship f32 steps at batch 32 through the
              parallel path (warp_mold, the bucketed gradient all-reduce
              executed) equal to the step without a mesh bit for bit
              (cuDNN deterministic), both steps timed in turns (median of
              10 each, twice; the run's cuDNN setting) beside phase 4's,
              int8 at batch 128 under shard_over of the mesh equal to
              unsharded serving bit for bit; (b) a 2 x 2 world of four
              processes under gloo, all on the one card (asked for by
              device=): the flagship recipe at full width (13,824-wide
              ori_final split by its in features) at a global batch of
              16, two steps, convolutions in full f32 (TF32 off, also
              in its reference): loss and every parameter against the world
              of one on the same global batch (rtol 2e-4, atol 2e-5, the
              JAX package's DP x TP bounds), each rank's first warp_mold
              call against the plain chain, rank 0's whole state equal
              to the gathered tree and resumed by a fresh 2 x 2 world bit
              for bit, int8 served over the 2 data rows (the int8 body
              equal to one rank's serving bit for bit, the float final
              within 1e-5, each rank's rows equal to the plain version);
              seconds and each rank's peak memory.
  8g. actq    TRAIN_ACT_Q8 in the recipes the JAX package trains it
              with (`run_actq_phase`), each under False, True and
              'wgrad8' in turns from the same seeded weights and batch:
              (a) the F16 flagship (ResNet-50, 512x640, batch 32); (b)
              benchmark_config(5) (ResNet-101, keypoints, F16, REMAT,
              batch 16; the validation decoded by the keypoint SVD; the
              gradients under each REMAT policy equal to those without;
              'wgrad8' and False stepped again without REMAT); (c) config
              2 through the command line on phase 6's frames (`run_actq_cli`:
              train 8 steps at batch 1 through the native loader, then
              evaluate --weights last; the C = 3 stem's weight gradient on
              the gather route); (d) the f32 flagship. `run_actq`: 3
              train steps + 1 validation step a mode: the first step's
              loss equal in every mode (the forward is exact), losses
              finite and falling, the launches a step of quant_s8 (by mode
              and by kernel: one launch a 'x' or 'g' call), wgrad_s8 (by
              route), the gather and their gemm_s8 equal to
              `actq_expected` (the convs, REMAT's recompute, the routes),
              every distinct quant_s8 / wgrad_s8 / im2col_s8 call of a
              step on fresh operands equal to its plain version (0
              differing values; wgrad_s8 on both routes, 'g' under a gloo
              group of one too), each timed by CUDA graph and by host
              pace beside its plain version, its bound and its library
              call (wgrad_s8: torch._int_mm on the same patch matrix, and
              its ragged route; im2col_s8: F.unfold where it takes int8);
              the median step time and one step's peak memory beside
              check_train_memory's estimate (outside ±25% the run fails
              where the mode is calibrated).
  8h. video   `test --video` (`run_video`): 24 synthetic 1280x960 URSO
              frames written as an MJPG AVI by the port's writer, then
              the CLI's test --video float and --int8 --f16 (the
              flagship's flags, batches of 8): every frame written, each
              frame's pose equal to engine.detect's on the reader's frames
              in the same batches, frames/s split into decode, serve, draw
              and encode.
 9. artifact the committed flagship int8 artifact served on its golden
              input under F16 and in the f32-epilogue mode: kernel path
              equal to the plain path, within the gate bound of the float
              twin, both int8 kernels launched; drift against the TPU
              goldens and decoded poses printed; its stem rewritten to
              space-to-depth form in memory and served through stem_s8
              gives the same bits.
 10. serve    int8 serving of serving_config() at full width and batch
              (128 × 512×640, seeded random weights; calibrate on 8
              images, smooth(0.5), bias_correct(passes=1), as bench.py)
              through ServingEngine.predict_molded, in the `base` and the
              `host_s2d` variant, under F16 (bench.py's mode) and with
              f32 epilogues: every int8 kernel of the variant launched
              (stem_s8 exactly once per batch: its 'nhwc' route from the
              raw batch under `base` and `s2d`, its 'tma' route on the
              host's packed pixels under `host_s2d`), in the served mode,
              outputs within the random-init gate of the float twin,
              decode and ESA score finite; the `s2d` variant equal to
              `host_s2d` bit for bit under F16; every GEMM, every 3x3
              conv and the fused stem of the served model must have
              taken the TMA + wgmma route (no mma.sync stem conv).
 10b. staging the served batch's host-to-device copy through the pinned
              staging ring (`utils/staging.py::to_device`, check_staging)
              against `.to(device)`: byte for byte for uint8 and float32,
              numpy and CPU tensors, non-contiguous inputs, batches of 1,
              7 and 128, and two calls back to back with the caller's
              array overwritten as soon as the first returns; the F16
              base flagship's served heads equal to those of the same
              batch copied by `.to()`, and every served call counted
              staged; the 126 MB copy both ways, its host copy and DMA
              alone, the served call both ways, and the ring at each
              slot size and count of STAGING_SWEEP, timed.
 11. probes   the four kernel-probe entry points at their own shapes
              (ursonet_torch.probes.fused_block, int8_mma, int4_mma,
              stem), their JSON lines printed as they come; the rate
              and stem probes run each kernel on both routes.
 12. numbers  train step and serving time per variant and mode, memory,
              the bf16 float forward at batch 128 (bench.py's
              BENCH_QUANT=0), and each kernel's time in both modes at the
              main paths' shapes beside its plain version (the fused warp
              at the flagship's u8 batch and config 4's gray plane, both
              interpolations, on M and identity flags drawn as each
              configuration's preprocess draws them: device time from a
              CUDA graph of 20 launches, averaged over 8 drawn batches,
              beside the host pace of back-to-back calls, the unfused
              chain it replaced, the unfused mode and F.grid_sample timed
              the same two ways, the share of tiles on the global path),
              the library call and the card's bound (the stem and the
              rate loops on both routes, with the SM clock read while
              they run; the stem's 'nhwc' route at the `base` batch's
              call, equal to its plain version and to the unfused chain
              it replaced (input quantize, conv_s8 on mma.sync,
              maxpool_s8), timed beside that chain; the block beside its
              unfused route, with the SM clock); every distinct int8 call
              of a served batch, and the block at the probe's shape, equal
              to its plain version at its full shape.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from ursonet_torch import evaluate, presets, se3, se3t
from ursonet_torch.checkpoint import store
from ursonet_torch.checkpoint.quant_store import save_quantized
from ursonet_torch.config import Config
from ursonet_torch.data import loader, native_loader, png
from ursonet_torch.data.loader import keypoint_scale, make_device_preprocess
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Camera, Urso
from ursonet_torch.engine import ServingEngine, UrsoNet
from ursonet_torch.models import quant
from ursonet_torch.models.resnet import FrozenBN, space_to_depth2, \
    stem_kernel_to_s2d
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import (actq_cuda, augment, cuda_build, int8_cuda,
                               warp_cuda)
from ursonet_torch.ops.image import resize_geometry, resize_image
from ursonet_torch.probes import fused_block, int4_mma, int8_mma, mma_rate
from ursonet_torch.probes import stem as stem_probe
from ursonet_torch.probes.timing import graph_ms, sm_clock_mhz
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_eval_step, make_train_step
from ursonet_torch.utils import memory, staging
from ursonet_torch.utils.memory import (check_train_memory,
                                        estimate_train_hbm_gb)

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the
# tensor cores, dense int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
# every row of the kernels line has these, beside its name and launches
LINE_KEYS = ('ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12

ACC_NAMES = int8_cuda.ACC_NAMES
ACC_DTYPES = {v: k for k, v in ACC_NAMES.items()}
FLAGSHIP_BATCH = 32
CONFIG5_BATCH = presets.benchmark_config(5).BATCH_SIZE
SPEED_BATCH = 4      # released_config('speed')'s bf16 forward
# benchmark_config(4)'s training batch: 4 frames of SPEED at 640x960
SPEED_TRAIN_SHAPE = (4, 640, 960)
# Each REMAT policy's gradients on the card against those without REMAT
# (remat_grad_rel), relative L2. Measured 0 for every policy at config
# 5's full width, and 0 between two runs without REMAT (NVIDIA H100 80GB
# HBM3, 700 W): cuDNN takes the same algorithms in the recompute and runs
# them deterministically, so the bound is exact.
REMAT_CARD_REL = 0.0
STEPS = 5            # train steps of the main path, then 1 validation step
SERVE_ITERS = 10     # timed serving calls, after 2 warm-up calls
# the staging ring's sizes timed beside staging.SLOT_BYTES and SLOTS
# (phase 10b): (slot MiB, slots)
STAGING_SWEEP = ((2, 3), (4, 2), (4, 3), (8, 2), (8, 3), (16, 2), (16, 3),
                 (32, 2), (32, 3))
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
    facts.update(host_toolchain_facts())
    return facts


def host_toolchain_facts() -> dict:
    """What a parallel host decoder could build on: the g++ version (it
    builds the port's JPEG codec and zstd decoder), whether zlib.h and
    zstd.h preprocess and libzstd.so.1 loads (the port uses neither: the
    Orbax store decodes zstd itself), and where a libnvjpeg is (the CUDA
    toolkit's lib dirs, then the loader's search)."""
    import ctypes.util
    facts = {}
    try:
        r = subprocess.run(['g++', '--version'], capture_output=True,
                           text=True, timeout=60)
        facts['g++'] = (r.stdout.splitlines() or ['?'])[0]
        r = subprocess.run(['g++', '-E', '-x', 'c++', '-'],
                           input='#include <zlib.h>\n', capture_output=True,
                           text=True, timeout=60)
        facts['zlib.h'] = 'found' if r.returncode == 0 else \
            'not found: ' + (r.stderr.strip().splitlines() or ['?'])[0]
    except FileNotFoundError:
        facts['g++'] = 'not found'
    from torch.utils.cpp_extension import CUDA_HOME
    libs = []
    for d in ('lib64', 'lib', 'targets/x86_64-linux/lib'):
        path = os.path.join(CUDA_HOME or '/usr/local/cuda', d)
        if os.path.isdir(path):
            libs += sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.startswith('libnvjpeg'))
    try:
        r = subprocess.run(['g++', '-E', '-x', 'c++', '-'],
                           input='#include <zstd.h>\n', capture_output=True,
                           text=True, timeout=60)
        facts['zstd.h'] = 'found' if r.returncode == 0 else \
            'not found: ' + (r.stderr.strip().splitlines() or ['?'])[0]
    except FileNotFoundError:
        pass
    try:
        ctypes.CDLL('libzstd.so.1')
        facts['libzstd.so.1'] = 'loads'
    except OSError as e:
        facts['libzstd.so.1'] = f'does not load ({e})'
    found = ctypes.util.find_library('nvjpeg')
    facts['libnvjpeg'] = ', '.join(libs) if libs else (
        f'found by the loader: {found}' if found else 'not found')
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
# template flag of the TMA GEMM / conv kernel, the first of the stem's
# (its second: the 'nhwc' route).
_BF16_INSTANCE = re.compile(r"(tma_s8_kernel<\d+, (true|false), true>|"
                            r"stem_s8_tma_kernel<true, (true|false)>)")


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


def net_intrinsics(cfg, cam=None) -> np.ndarray:
    """The camera's K (URSO's by default) scaled to the network
    resolution of `cfg`."""
    cam = cam or Camera()
    _, window, scale = resize_geometry(
        cam.height, cam.width, cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM,
        cfg.IMAGE_MIN_SCALE, cfg.IMAGE_RESIZE_MODE)
    return augment.scaled_intrinsics(cam.K, window, scale)


def speed_intrinsics() -> np.ndarray:
    """SPEED's K at config 4's network resolution."""
    from ursonet_torch.data.speed import Camera as SpeedCamera
    return net_intrinsics(presets.benchmark_config(4), SpeedCamera())


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


def run_main_path(cfg, device, seed: int = 0, steps: int = 5,
                  model=None) -> dict:
    """`steps` train steps on one raw batch, each with the same draws (so
    the loss is taken on the same preprocessed batch), then one
    validation step, of `model` (else one built from `seed`). Returns
    the losses, the step fn, the model, the preprocess and the raw
    batch."""
    if model is None:
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


def _device_gen(rng, dev):
    """A generator on the card seeded from `rng`, or None on the CPU."""
    dev = torch.device(dev)
    if dev.type != 'cuda':
        return None
    return torch.Generator(device=dev).manual_seed(int(rng.randint(2**31)))


def s8(rng, shape, dev):
    """Random int8 operands drawn from `rng`: on the card by a generator
    seeded from it (host draws of the served shapes took seconds)."""
    g = _device_gen(rng, dev)
    if g is not None:
        return torch.randint(-128, 128, shape, dtype=torch.int8,
                             device=dev, generator=g)
    return torch.from_numpy(
        rng.randint(-128, 128, shape).astype(np.int8)).to(dev)


def join_res(dev, rng, out_shape, epilogue, res='s8') -> dict:
    """A join's residual of type `res` ('s8', 'f32' or 'bf16') and its
    res_scale, as Int8Ops passes them: an int8 shortcut at a step of
    0.0123 (`join`) or at a ratio of 0.61 to the output step (`join_s8`),
    a float shortcut at about ±2 taken as it is (`join`) or at the
    reciprocal output step (`join_s8`)."""
    if res == 's8':
        return dict(res=s8(rng, out_shape, dev),
                    res_scale=0.0123 if epilogue == 'join' else 0.61)
    g = _device_gen(rng, dev)
    if g is not None:
        v = torch.rand(out_shape, device=dev, generator=g) * 4 - 2
    else:
        v = torch.from_numpy(rng.uniform(-2, 2, out_shape)
                             .astype(np.float32))
    dt = {'f32': torch.float32, 'bf16': torch.bfloat16}[res]
    return dict(res=v.to(dt).to(dev),
                res_scale=1.0 if epilogue == 'join'
                else float(np.float32(1) / np.float32(3.0 / 127)))


def join_residuals(epilogue, acc_dtype) -> tuple:
    """The residual types Int8Ops gives `epilogue` in a mode: an int8
    shortcut, or a float one (`join`: the 'f32' epilogue's type; join_s8:
    'f32_sum', f32); ('s8',) for the others, which take none."""
    if epilogue == 'join':
        return ('s8', ACC_NAMES[acc_dtype])
    return ('s8', 'f32') if epilogue == 'join_s8' else ('s8',)


def epilogue_args(dev, rng, out_shape, k, epilogue, res='s8') -> dict:
    """Epilogue operands that put y = acc * alpha + beta at about ±3 for
    random s8 operands of depth k, and the requantized values across
    -127..127, so rounding and clipping are both exercised; the joins'
    residual of type `res` (`join_res`)."""
    n = out_shape[-1]
    alpha = rng.uniform(0.5, 1.5, n) * 3.0 / (np.sqrt(k) * 128 * 128 / 3)
    kw = dict(alpha=torch.from_numpy(alpha.astype(np.float32)).to(dev),
              beta=torch.from_numpy(
                  rng.uniform(-1, 1, n).astype(np.float32)).to(dev),
              inv_s_out=float(np.float32(1) / np.float32(3.0 / 127)))
    if epilogue in int8_cuda.JOINS:
        kw.update(join_res(dev, rng, out_shape, epilogue, res))
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
                if ep in int8_cuda.JOINS or k_ not in ('res', 'res_scale')}
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
    accumulation) in every epilogue (the joins over each residual type
    `join_residuals` gives them), in both accumulation modes (f32 and
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
                for res in join_residuals(ep, mode):
                    args = dict(epilogue_args(dev, rng, out_shape, k, ep,
                                              res), acc_dtype=mode)
                    want = int8_cuda.epilogue_torch(acc, ep, **args)
                    for route in routes:
                        compare(f"{name} {ep} {ACC_NAMES[mode]} res {res} "
                                f"[{route}]", launch(ep, route, args), want)
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


def nhwc_operands(dev, rng, b, h, w):
    """A raw u8 batch [b, h, w, 3], a 7x7 stem kernel and its s2d form
    (the 'nhwc' route's)."""
    x = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3), np.uint8))
    w7 = rng.randint(-127, 128, (7, 7, 3, 64)).astype(np.int8)
    return (x.to(dev), int8_cuda.kernel_layout(w7).to(dev),
            int8_cuda.kernel_layout(stem_kernel_to_s2d(w7)).to(dev))


def nhwc_args(dev, rng, mode) -> dict:
    """stem_args with the pixel mean per raw channel."""
    kw = stem_args(dev, rng, mode)
    return dict(kw, mean=kw['mean'][:3])


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
    # the 'nhwc' route from the raw batch: the flagship's images, and
    # tiles that overhang every border
    for b, h, w in [(batch, 512, 640), (3, 74, 96), (2, 58, 208)]:
        x, w7, w4 = nhwc_operands(dev, rng, b, h, w)
        if int8_cuda.stem_route(w, True, 3, h) != 'nhwc':
            raise RuntimeError(f"stem_s8 {b}x{h}x{w}x3: not the nhwc route")
        for mode in int8_cuda.STEM_MODES:
            for acc in int8_cuda.ACC_DTYPES:
                kw = dict(nhwc_args(dev, rng, mode), acc_dtype=acc)
                want = int8_cuda.stem_s8_nhwc_torch(x, w7, **kw)
                tag = f"stem_s8 {mode} {ACC_NAMES[acc]} {b}x{h}x{w}x3"
                _must_equal(f"{tag} [nhwc]", int8_cuda.stem_s8(x, w4, **kw),
                            want)
                _must_equal(f"{tag} [tma, packed]", int8_cuda.stem_s8(
                    space_to_depth2(x).contiguous(), w4, route='tma',
                    **dict(kw, mean=np.tile(kw['mean'], 4))), want)
        log(f"check stem_s8 {b}x{h}x{w}x3 -> 64 [nhwc]: calibrated and "
            "shift128, f32 and bf16 epilogues, bit-exact against the 7x7 "
            "chain and the tma route on the packed pixels")
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
    once per batch: on its 'nhwc' route under `base` and `s2d`, on 'tma'
    under `host_s2d`), every launch in the mode, and the outputs stay
    within the random-init gate of the float twin."""
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
    if min(launches['gemm_s8'], launches['conv_s8']) < 1 \
            or launches['stem_s8'] != 1:
        raise RuntimeError(f"the {variant} serving path must launch gemm_s8 "
                           f"and conv_s8, and stem_s8 once a batch: "
                           f"{launches}")
    check_served_routes(tag, calls,
                        stem='tma' if variant == 'host_s2d' else 'nhwc')
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


def check_served_routes(variant, calls, stem=None) -> None:
    """Every GEMM, every 3x3 conv and the fused stem of a served batch
    must have taken the TMA + wgmma route: the fused stem its 'tma' route
    on packed pixels or its 'nhwc' one on the raw batch (`stem`: the
    route each stem_s8 call of the batch must take, where given). A C = 3
    stem conv on mma.sync only where the 'nhwc' route does not take the
    batch's shape."""
    routes = Counter((name, a['route']) for name, a in calls if 'route' in a)
    log(f"serve [{variant}] routes per batch: "
        + ", ".join(f"{n} {r} x{c}" for (n, r), c in sorted(routes.items())))
    for name, a in calls:
        if name == 'stem_s8':
            ok = a['route'] == (stem or ('nhwc' if a['c'] == 3 else 'tma'))
        elif name == 'conv_s8' and a['c'] == 3:
            ok = a['route'] == 'ragged' and int8_cuda.stem_route(
                a['w'], True, 3, a['h']) is None
        else:
            ok = a['route'] == 'tma'
        if not ok:
            raise RuntimeError(f"serve [{variant}]: {name} {a} is off its "
                               "route (tma; the fused stem's nhwc on the raw "
                               "batch)")


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
    if int8_cuda.launches['stem_s8'] != 1 \
            or int8_cuda.launches['stem_s8_nhwc'] != 1:
        raise RuntimeError("s2d did not run stem_s8 on its nhwc route: "
                           f"{int8_cuda.launches}")
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


def both_ways(fn, iters: int = 50) -> dict:
    """fn's device time (graph_ms) and its host pace: the mean of `iters`
    back-to-back calls between two events (cuda_ms), which a call's host
    work (checks, allocation, the launch) bounds from below as much as
    its device time."""
    return {'ms': graph_ms(fn), 'host_ms': cuda_ms(fn, iters)}


def _bound(ops, nbytes, rate) -> dict:
    """The card's least time for `ops` operations at `rate` and `nbytes`
    bytes at HBM_BYTES_PER_S, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def _chain(src, Ms, identity, mean, interp):
    """The unfused chain the fused kernel replaced, on the card: the cast
    to f32 NCHW (or the gray plane broadcast), the warp kernel in its
    unfused mode, torch.where, the mold."""
    if src.dtype == torch.uint8:
        images = src.permute(0, 3, 1, 2).contiguous().to(torch.float32)
        warped = warp_cuda.warp_cuda(images, Ms, interp)
    else:
        images = src.expand(src.shape[0], 3, *src.shape[2:])
        warped = warp_cuda.warp_cuda_gray(images, Ms, interp)
    return torch.where(identity[:, None, None, None], images, warped) - mean


def fused_inputs(dev, rng, b, h, w, K, gray: bool):
    """A u8 batch [B,H,W,3] (or a f32 gray plane [B,1,H,W]), homographies
    (half camera rotations, half rolls) and identity flags (every third
    image), on the card."""
    if gray:
        src = (rng.rand(b, 1, h, w) * 255).astype(np.float32)
    else:
        src = rng.randint(0, 256, (b, h, w, 3), np.uint8)
    Ms = homographies(b, K, rng)
    ident = np.arange(b) % 3 == 1
    return (torch.from_numpy(src).to(dev), torch.from_numpy(Ms).to(dev),
            torch.from_numpy(ident).to(dev))


def drawn_inputs(dev, rng, seed, cfg, b, h, w, K, gray, n_draws):
    """The traffic a train path of `cfg` sends the fused kernel: a random
    u8 batch [B,H,W,3] (or f32 gray plane [B,1,H,W]) and `n_draws` pairs
    (M, identity flags) drawn as its preprocess draws them
    (draw_rotation, rotation_update under cfg's ROT_AUG and
    ROT_IMAGE_AUG), on the card."""
    if gray:
        src = (rng.rand(b, 1, h, w) * 255).astype(np.float32)
    else:
        src = rng.randint(0, 256, (b, h, w, 3), np.uint8)
    gen = torch.Generator(device=dev).manual_seed(seed)
    locs = torch.zeros(b, 3, device=dev)
    quats = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev).expand(b, 4)
    draws = []
    for _ in range(n_draws):
        M, ident, _, _ = augment.rotation_update(
            locs, quats, K, augment.draw_rotation(gen, b, 20.0),
            cfg.ROT_AUG, cfg.ROT_IMAGE_AUG)
        draws.append((M, ident))
    return torch.from_numpy(src).to(dev), draws


def tile_stats(src, Ms, ident, mean, interp) -> tuple:
    """(tiles on the global path, tiles) of one fused launch."""
    stats = torch.zeros(2, dtype=torch.int32, device=src.device)
    warp_cuda.warp_mold(src, Ms, ident, mean, interp, stats=stats)
    torch.cuda.synchronize()
    return int(stats[0]), int(stats[1])


# draws of (M, identity) the fused kernel is timed over, per shape
FUSED_TIMED_DRAWS = 8


def time_fused(src, draws, mean, interp) -> dict:
    """The fused kernel (device time and host pace), its plain version,
    the unfused chain it replaced (both ways) and, for the unfused mode,
    the unfused kernel and F.grid_sample (both ways), on the same inputs,
    with the card's bounds: the fused function's bytes (source read once,
    f32 [B,3,H,W] written once, M and the flags) and the unfused mode's
    (f32 planes in and out); ~20 flops a pixel for the coordinate and ~11
    a pixel and channel for bilinear, for the images warped. The device
    times of the kernel and the chain are the means over `draws` (each
    (M, identity) of one batch); `ms_min`/`ms_max` the kernel's spread
    over them; the global-path and identity shares are over all draws;
    the host paces, the plain version and the unfused mode are read on
    the first draw."""
    gray = src.dtype == torch.float32
    b = src.shape[0]
    h, w = (src.shape[2], src.shape[3]) if gray else (src.shape[1],
                                                      src.shape[2])
    c_src = 1 if gray else 3
    mean_t = torch.from_numpy(np.asarray(mean, np.float32)).to(
        src.device).view(1, 3, 1, 1)
    n_ident = sum(int(ident.sum()) for _, ident in draws)
    warped = len(draws) * b - n_ident
    flops = (20 * h * w + (11 * 3 * h * w if interp == 'bilinear' else 0)) \
        * warped / len(draws)
    per_draw = [graph_ms(lambda: warp_cuda.warp_mold(src, Ms, ident, mean,
                                                     interp))
                for Ms, ident in draws]
    chain = [graph_ms(lambda: _chain(src, Ms, ident, mean_t, interp))
             for Ms, ident in draws]
    tiles = [tile_stats(src, Ms, ident, mean, interp) for Ms, ident in draws]
    Ms, ident = draws[0]
    out = {'ms': statistics.mean(per_draw), 'ms_min': min(per_draw),
           'ms_max': max(per_draw),
           'host_ms': cuda_ms(lambda: warp_cuda.warp_mold(
               src, Ms, ident, mean, interp), 50),
           'plain_ms': cuda_ms(lambda: augment.warp_mold_torch(
               src, Ms, ident, mean, interp), 5),
           'library_ms': None,
           'bytes': b * h * w * c_src * src.element_size()
           + 4 * b * 3 * h * w + 4 * 9 * b + b,
           'global_share': sum(g for g, _ in tiles) / sum(t for _, t in tiles),
           'identity_share': n_ident / (len(draws) * b),
           'draws': len(draws),
           'chain_ms': statistics.mean(chain),
           'chain_host_ms': cuda_ms(lambda: _chain(src, Ms, ident, mean_t,
                                                   interp), 50)}
    out.update(_bound(flops, out['bytes'], F32_FLOP_PER_S))
    # the unfused mode on the f32 planes the chain warps
    planes = src if gray else src.permute(0, 3, 1, 2).contiguous().to(
        torch.float32)
    kernel = warp_cuda.warp_cuda_gray if gray else warp_cuda.warp_cuda
    grid = grid_from_homography(Ms, h, w)
    plain = (augment.warp_nearest_torch if interp == 'nearest'
             else augment.warp_bilinear_torch)
    unfused = {**both_ways(lambda: kernel(planes, Ms, interp)),
               'plain_ms': cuda_ms(lambda: plain(planes, Ms), 5),
               'bytes': 2 * 4 * b * c_src * h * w + 4 * 9 * b}
    unfused.update(_bound(20 * b * h * w + (11 * b * c_src * h * w
                                            if interp == 'bilinear' else 0),
                          unfused['bytes'], F32_FLOP_PER_S))
    lib = both_ways(lambda: F.grid_sample(planes, grid, mode=interp,
                                          padding_mode='zeros',
                                          align_corners=True))
    unfused['library_ms'], unfused['library_host_ms'] = lib['ms'], \
        lib['host_ms']
    out['unfused'] = unfused
    return out


def log_fused(tag, t, card) -> None:
    u = t['unfused']
    log(f"warp_mold {tag}: kernel {t['ms']:.4f} ms device (mean over "
        f"{t['draws']} drawn batches, {t['ms_min']:.4f}-{t['ms_max']:.4f}; "
        f"each a CUDA graph of 20 launches), host pace {t['host_ms']:.4f} "
        f"ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B "
        f"at 3.35 TB/s; {t['bound_ms'] / t['ms']:.3f} of it); plain "
        f"{t['plain_ms']:.4f} ms; the unfused chain (cast + warp + where + "
        f"mold) {t['chain_ms']:.4f} ms device, {t['chain_host_ms']:.4f} ms "
        f"host pace; images left as they are {t['identity_share']:.4f}; "
        f"tiles on the global path {t['global_share']:.6f} {card}")
    log(f"warp_homography (unfused mode) {tag}, first draw: kernel "
        f"{u['ms']:.4f} ms device, {u['host_ms']:.4f} ms host pace; plain "
        f"{u['plain_ms']:.4f} ms; F.grid_sample "
        f"{u['library_ms']:.4f} ms device, {u['library_host_ms']:.4f} ms host"
        f" pace; bound {u['bound_ms']:.4f} ms ({u['bound_by']}) {card}")


def _int8_call(name, a, dev, rng):
    """Fresh operands for one recorded GEMM or conv call: (kernel fn,
    plain fn, library fn or None, operations, bytes), in the call's
    accumulation mode and, for a join, on a residual of the call's type.
    The bytes count each input once (activations, weights, epilogue
    vectors, residual) and each output once (bf16 for the f32 epilogues
    of the bf16 mode)."""
    ep = a['epilogue']
    acc = ACC_DTYPES[a['acc']]
    ob = int8_cuda.OUT_BYTES[acc][ep]
    res = a.get('res', 's8')
    rb = {'s8': 1, 'bf16': 2, 'f32': 4}[res] if ep in int8_cuda.JOINS \
        else 0
    if name == 'gemm_s8':
        m, k, n = a['m'], a['k'], a['n']
        x = s8(rng, (m, k), dev)
        wt = int8_cuda.kernel_layout(
            rng.randint(-128, 128, (k, n)).astype(np.int8)).to(dev)
        kw = dict(epilogue_args(dev, rng, (m, n), k, ep, res),
                  acc_dtype=acc)
        ops = 2 * m * n * k
        nbytes = m * k + k * n + m * n * ob
        return (lambda: int8_cuda.gemm_s8(x, wt, ep, **kw),
                lambda: int8_cuda.gemm_s8_torch(x, wt, ep, **kw),
                lambda: torch._int_mm(x, wt),
                ops, nbytes + 8 * n + m * n * rb)
    b, h, w, c = a['b'], a['h'], a['w'], a['c']
    kh, kw_, n, st, pads = a['kh'], a['kw'], a['n'], a['stride'], a['padding']
    oh, ow = int8_cuda.conv_out_hw(h, w, kh, kw_, st, pads)
    x = s8(rng, (b, h, w, c), dev)
    wt = int8_cuda.kernel_layout(
        rng.randint(-128, 128, (kh, kw_, c, n)).astype(np.int8)).to(dev)
    kw = dict(epilogue_args(dev, rng, (b, oh, ow, n), kh * kw_ * c, ep, res),
              acc_dtype=acc)
    m = b * oh * ow
    ops = 2 * m * n * kh * kw_ * c
    nbytes = b * h * w * c + kh * kw_ * c * n + m * n * ob
    return (lambda: int8_cuda.conv_s8(x, wt, st, pads, ep, **kw),
            lambda: int8_cuda.conv_s8_torch(x, wt, st, pads, ep, **kw),
            None, ops, nbytes + 8 * n + m * n * rb)


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
    recorded one took: the wrapper picks it from the same shapes). The
    fused stem's call is timed apart (time_stem_nhwc)."""
    groups = Counter((name, tuple(sorted(a.items()))) for name, a in calls
                     if name in ('gemm_s8', 'conv_s8'))
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


def time_serving(engine, images, dev, iters: int = SERVE_ITERS,
                 host: bool = True) -> dict:
    """Median int8 forward time of a device-resident batch (packed on
    the host first under host_s2d) over `iters` calls after 2 warm-up
    calls (CUDA events), and (`host`) the host wall time of
    predict_molded from host uint8 (reindex and copy included)."""
    x = torch.from_numpy(engine._host_s2d_maybe(images)).to(dev)
    qm = engine.qmodel
    times = []
    for i in range(2 + iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        qm(x)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    out = {'median_ms': statistics.median(times), 'all_ms': times}
    if host:
        wall = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.predict_molded(images)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        out['host_ms'] = statistics.median(wall)
    return out


def host_batches(dev, n: int, shape, dtype=np.uint8) -> list:
    """n arrays of random bytes of `shape` and `dtype` in host memory,
    drawn on the card."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return [torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
            .cpu().numpy().view(dtype).reshape(shape) for _ in range(n)]


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


def wall_ms(fn, iters: int) -> list:
    """Host wall ms of fn(i) to a synchronize, for i in range(iters),
    after one warm-up call."""
    fn(0)
    torch.cuda.synchronize()
    out = []
    for i in range(iters):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def check_staging(dev, served, card: str = '', iters: int = 10) -> dict:
    """Phase 10b: the served batch's copy through the pinned staging ring
    (`utils/staging.py::to_device`) against `.to(device)`. Byte for byte:
    uint8 and float32, numpy arrays, CPU tensors and non-contiguous
    inputs, batches of 1, 7 and 128 at the flagship's 512x640; two calls
    back to back with the caller's array overwritten right after the
    first returns; the flagship's served heads (`served`: serve_flagship's
    result) through the ring equal to those of the same batch copied by
    `.to()`, and every served call counted staged. Then host wall ms to a
    synchronize, medians of `iters`, on a pool of 4 batches of 128 as
    the benchmark serves them: the batch's copy both ways, the host copy
    into pinned memory and the pinned DMA alone, the served call with its
    heads brought back both ways, and the ring at each size of
    STAGING_SWEEP, in two rounds of opposite order."""
    engine, images = served['engine'], served['images']
    qm = engine.qmodel
    h, w = images.shape[1:3]
    cases = 0
    for dtype in (np.uint8, np.float32):
        for batch in (1, 7, 128):
            a = host_batches(dev, 1, (batch, h, w, 3), dtype)[0]
            t = torch.from_numpy(a)
            for kind, x in (('numpy', a), ('tensor', t),
                            ('transposed', t.transpose(1, 2)),
                            ('numpy strided', a[:, ::2])):
                want = (x if isinstance(x, torch.Tensor) else
                        torch.from_numpy(np.ascontiguousarray(x))).to(dev)
                got = staging.to_device(x, dev)
                torch.cuda.synchronize()
                if not _same_bytes(got, want):
                    raise RuntimeError(
                        f"staging: {kind} {np.dtype(dtype).name} batch "
                        f"{batch} differs from .to(device)")
                cases += 1
    a = host_batches(dev, 1, (128, h, w, 3))[0]
    keep = a.copy()
    first = staging.to_device(a, dev)
    np.subtract(255, a, out=a)
    second = staging.to_device(a, dev)
    a[:] = 0
    torch.cuda.synchronize()
    if not (torch.equal(first.cpu(), torch.from_numpy(keep))
            and torch.equal(second.cpu(), torch.from_numpy(255 - keep))):
        raise RuntimeError("staging: a batch changed when the caller "
                           "overwrote its array after the call returned")
    before = staging.counts['passed']
    if staging.to_device(first, dev) is not first \
            or staging.counts['passed'] != before + 1:
        raise RuntimeError("staging: a tensor on the card must pass through")
    log(f"staging: {cases} inputs and the overwritten batch equal to "
        f".to(device) byte for byte; slots {staging.SLOTS} x "
        f"{staging.SLOT_BYTES >> 20} MiB; host threads "
        f"{torch.get_num_threads()} of {os.cpu_count()} cores")

    staging.reset_counts()
    outs = [engine.predict_molded(images) for _ in range(3)]
    counts = dict(staging.counts)
    nbytes = images.nbytes
    want = {'staged': 3, 'passed': 0,
            'chunks': 3 * len(staging.chunk_plan(nbytes)), 'bytes': 3 * nbytes}
    if counts != want:
        raise RuntimeError(f"staging: served calls counted {counts}, "
                           f"want {want}")
    paged = qm(torch.from_numpy(engine.served_batch(images)).to(dev))
    for out in outs:
        for k, v in paged.items():
            if not torch.equal(out[k], v):
                raise RuntimeError(f"staging: served head {k} differs from "
                                   f"the pageable copy's")
    log(f"staging: 3 served batches counted {counts}; their heads equal "
        f"the pageable copy's bit for bit")

    pool = host_batches(dev, 4, tuple(images.shape))
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    flat = [torch.from_numpy(p).view(-1) for p in pool]

    def served_heads(x):
        return {k: v.cpu() for k, v in qm(x).items()}

    ways = {
        'pageable .to()': lambda i: torch.from_numpy(pool[i % 4]).to(dev),
        'staged': lambda i: staging.to_device(pool[i % 4], dev),
        'host copy alone': lambda i: pinned.copy_(flat[i % 4]),
        'pinned DMA alone': lambda i: dst.copy_(pinned, non_blocking=True),
        'serve, pageable': lambda i: served_heads(
            torch.from_numpy(pool[i % 4]).to(dev)),
        'serve, staged': lambda i: served_heads(pool[i % 4]),
    }
    card_dev = torch.device('cuda', torch.cuda.current_device())
    for mib, slots in STAGING_SWEEP:
        ring = staging.Ring(card_dev, mib << 20, slots)
        ways[f'ring {mib} MiB x {slots}'] = \
            lambda i, ring=ring: staging.stage(flat[i % 4], dst, ring)
    # two rounds in opposite orders, so a drift of the host's pace
    # weighs on every way alike
    ms = {k: [] for k in ways}
    for order in (list(ways), list(ways)[::-1]):
        for k in order:
            ms[k] += wall_ms(ways[k], iters)
    med = {k: statistics.median(v) for k, v in ms.items()}
    for k, v in med.items():
        rate = f", {nbytes / v / 1e6:.2f} GB/s" if 'serve' not in k else ""
        qs = ' '.join(f'{q:.3f}' for q in statistics.quantiles(ms[k], n=4))
        log(f"staging: {k}: median {v:.3f} ms of {len(ms[k])} (quartiles "
            f"{qs}){rate} {card}")
    return {'ms': med, 'counts': counts, 'cases': cases}


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


def time_stem_nhwc(dev, rng, card, a) -> dict:
    """stem_s8's 'nhwc' route at the raw batch, input mode and
    accumulation mode of the served `base` call `a`: equal to its plain
    version (the 7x7 chain in float64, 32 images at a time) and to the
    unfused chain of kernels it replaced on the same images (input
    quantize, conv_s8 7x7/2 on its mma.sync route with the q8_relu
    epilogue, maxpool_s8), 0 differing elements; both timed by 10
    launches, the SM clock read while the kernel runs. The bound counts
    the 7x7 conv's 2 * 147 * 64 operations at every conv pixel (not the
    s2d form's 192-deep products) and the raw pixels read once, the
    pooled output written once, the weights and epilogue vectors. No
    library call computes it (PyTorch has no CUDA int8 conv)."""
    b, h, w = a['b'], 2 * a['h2'], 2 * a['w2']
    x, w7, w4 = nhwc_operands(dev, rng, b, h, w)
    kw = dict(nhwc_args(dev, rng, a['mode']), acc_dtype=ACC_DTYPES[a['acc']])

    def plain():
        return torch.cat([int8_cuda.stem_s8_nhwc_torch(x[i:i + 32], w7, **kw)
                          for i in range(0, b, 32)])

    def kernel():
        return int8_cuda.stem_s8(x, w4, **kw)

    def chain():
        q, _ = int8_cuda.stem_input_s8(x, kw['mode'], kw['mean'],
                                       kw['inv_s_in'])
        y = int8_cuda.conv_s8(q, w7, 2, ((3, 3), (3, 3)), 'q8_relu',
                              kw['alpha'], kw['beta'], kw['inv_s_out'],
                              acc_dtype=kw['acc_dtype'])
        return int8_cuda.maxpool_s8(y)
    if int8_cuda.conv_route(3, 64, 49) != 'ragged':
        raise RuntimeError("the unfused C = 3 stem conv is not on mma.sync")
    want = plain()
    plain_ms = cuda_ms(plain, 1, 0)
    _must_equal(f"stem_s8 [nhwc] {b}x{h}x{w}x3", kernel(), want)
    _must_equal(f"stem chain [conv_s8 ragged] {b}x{h}x{w}x3", chain(), want)
    del want
    turns = [cuda_ms(kernel, 10, 1), cuda_ms(chain, 10, 1),
             cuda_ms(kernel, 10, 1)]
    ms, chain_ms = statistics.mean(turns[::2]), turns[1]
    h2, w2 = h // 2, w // 2
    ops = 2 * b * h2 * w2 * 147 * 64
    nbytes = b * h * w * 3 + b * (-(-h2 // 2)) * (-(-w2 // 2)) * 64 \
        + 147 * 64 + 8 * 64
    out = dict(ms=ms, plain_ms=plain_ms, library_ms=None, chain_ms=chain_ms,
               sm_clock_mhz=sm_clock_mhz(kernel, ms, dev),
               **_bound(ops, nbytes, INT8_OP_PER_S))
    log(f"stem_s8 [nhwc] {b}x{h}x{w}x3 {a['mode']} {a['acc']}: 0 differing "
        f"elements against the plain version and against the unfused chain "
        f"(input quantize, conv_s8 7x7/2 on mma.sync, maxpool_s8); kernel "
        f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s of the 7x7 conv, "
        f"{nbytes / ms / 1e6:.1f} GB/s, SM clock {out['sm_clock_mhz']:.0f} "
        f"MHz), the unfused chain {chain_ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}: {ops} op at "
        f"1979 TOP/s, {nbytes} B at 3.35 TB/s), no library call {card}")
    return out


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
    flagship, of config 5 and of config 4 (SPEED's 640x960 with its
    camera) and at a ragged size: nearest exact, bilinear within 1e-3;
    RGB and gray. Returns the max abs error."""
    max_err = 0.0
    for (b, c, h, w), Kb in [((FLAGSHIP_BATCH, 3, 512, 640), K),
                             ((CONFIG5_BATCH, 3, 512, 640), K),
                             ((SPEED_TRAIN_SHAPE[0], 3) + SPEED_TRAIN_SHAPE[1:],
                              speed_intrinsics()),
                             ((3, 3, 100, 130), K)]:
        imgs = torch.from_numpy(
            (rng.rand(b, c, h, w) * 255).astype(np.float32)).to(dev)
        Ms = torch.from_numpy(homographies(b, Kb, rng)).to(dev)
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


def _fused_err(tag, got, ref, interp) -> float:
    """Nearest: 0 differing elements; bilinear within 1e-3. Returns the
    max abs error."""
    diff = (got - ref).abs()
    err = float(diff.max())
    n = int((got != ref).sum())
    if interp == 'nearest':
        ok = n == 0
        log(f"check {tag}: differing elements {n} (tol 0)")
    else:
        ok = err <= 1e-3
        log(f"check {tag}: max_abs_err={err} (tol 1e-3)")
    if not ok:
        raise RuntimeError(f"warp_mold disagrees with the plain chain: {tag}")
    return err


def ragged_intrinsics(h, w) -> np.ndarray:
    """A camera centred on a small h x w image (focal 65 px), so that its
    rotations keep the source in view and the partial tiles at the right
    and bottom edges sample it."""
    return np.array([[65.0, 0, w / 2], [0, 65.0, h / 2], [0, 0, 1]])


def check_fused_warp(dev, rng, K, mean) -> float:
    """The fused kernel (warp_mold) against its plain version, the chain,
    at the flagship's 32x512x640 u8 batch and config 4's 4x1x640x960 gray
    plane (SPEED's camera), both interpolations, with every third image
    left as it is (identity), then with none and all; at a ragged size
    whose u8 rows TMA cannot address (every tile on the global path); and
    at ragged sizes TMA addresses (u8 rows of 336 bytes, f32 rows of 400),
    whose partial tiles load their boxes by TMA with its zero fill past
    the edges. Without identity images a TMA-addressable source must put
    some tiles on the box path. Returns the max abs error."""
    max_err = 0.0
    for (b, h, w), Kb, gray in [
            ((FLAGSHIP_BATCH, 512, 640), K, False),
            (SPEED_TRAIN_SHAPE, speed_intrinsics(), True),
            ((3, 100, 130), K, False),
            ((3, 100, 112), ragged_intrinsics(100, 112), False),
            ((3, 100, 100), ragged_intrinsics(100, 100), True)]:
        src, Ms, ident = fused_inputs(dev, rng, b, h, w, Kb, gray)
        boxed = warp_cuda.tma_addressable(src)
        for interp in ('nearest', 'bilinear'):
            for flags in ('mixed', 'none', 'all'):
                idf = {'mixed': ident, 'none': torch.zeros_like(ident),
                       'all': torch.ones_like(ident)}[flags]
                stats = torch.zeros(2, dtype=torch.int32, device=dev)
                got = warp_cuda.warp_mold(src, Ms, idf, mean, interp,
                                          stats=stats)
                torch.cuda.synchronize()
                n_global, tiles = int(stats[0]), int(stats[1])
                if flags == 'none' and (n_global < tiles) != boxed:
                    raise RuntimeError(
                        f"warp_mold {b}x{h}x{w}: {n_global} of {tiles} tiles"
                        f" on the global path, TMA-addressable {boxed}")
                ref = augment.warp_mold_torch(src, Ms, idf, mean, interp)
                tag = (f"warp_mold {interp} {'gray' if gray else 'u8'} "
                       f"{b}x{h}x{w} identity {flags}, tiles on the global "
                       f"path {n_global}/{tiles}")
                max_err = max(max_err, _fused_err(tag, got, ref, interp))
    return max_err


class _FusedWarps:
    """While open, keeps the first call of the fused warp (its inputs and
    output) that the preprocess makes."""

    def __enter__(self):
        self.saved = warp_cuda.warp_mold
        self.first = None

        def recorded(src, Ms, identity, mean, interpolation='nearest',
                     **kw):
            out = self.saved(src, Ms, identity, mean, interpolation, **kw)
            if self.first is None:
                self.first = (src.clone(), Ms.clone(), identity.clone(),
                              np.array(mean, np.float32), interpolation,
                              out.clone())
            return out
        warp_cuda.warp_mold = recorded
        return self

    def __exit__(self, *exc):
        warp_cuda.warp_mold = self.saved


class _NativeBatches:
    """While open, counts the batches the native loader fills
    (`native_loader.load_batch`, from any thread) and keeps the first
    `keep` calls' arguments and batches."""

    keep = 2

    def __enter__(self):
        self.saved = native_loader.load_batch
        self.count, self.first = 0, []
        lock = threading.Lock()

        def recorded(paths, *geom, **kw):
            out = self.saved(paths, *geom, **kw)
            with lock:
                self.count += 1
                if len(self.first) < self.keep:
                    self.first.append((list(paths), geom, out.copy()))
            return out
        native_loader.load_batch = recorded
        return self

    def __exit__(self, *exc):
        native_loader.load_batch = self.saved


def check_native_batches(tag, rec) -> None:
    """The recorded native batches against `load_batch_plain` (numpy on
    the port's Python codecs) on the same files: any differing value
    raises."""
    if len(rec.first) < rec.keep:
        raise RuntimeError(f"{tag}: {rec.count} native batches, "
                           f"{rec.keep} expected")
    for paths, geom, got in rec.first:
        want = native_loader.load_batch_plain(paths, *geom)
        diff = int((got != want).sum())
        if diff:
            raise RuntimeError(f"{tag}: a native batch differs from "
                               f"load_batch_plain in {diff} values")
    log(f"{tag}: {rec.count} native batches; the first {len(rec.first)} "
        f"({tuple(rec.first[0][2].shape)}) equal load_batch_plain bit for "
        "bit")


def check_fused_call(tag, first, cuda: bool = True) -> float:
    """The first recorded warp_mold call of a train path, at its full
    shape, against the plain chain on the same inputs. On the card a path
    that made no call fails; on the CPU (a configuration without rotation)
    there is nothing to check."""
    if first is None:
        if not cuda:
            return 0.0
        raise RuntimeError(f"{tag}: the preprocess never called warp_mold")
    src, Ms, ident, mean, interp, got = first
    ref = augment.warp_mold_torch(src, Ms, ident, mean, interp)
    return _fused_err(f"{tag}: first warp_mold call {tuple(src.shape)} "
                      f"{src.dtype} identity {int(ident.sum())}/{len(ident)}",
                      got, ref, interp)


def check_memory(tag, cfg, peak, card) -> float:
    """check_train_memory's calibrated estimate beside the measured peak
    of one train step; outside ±25% of it the run fails. Returns the
    estimate / peak."""
    est = check_train_memory(cfg, 'cuda', log)
    ratio = est * 1e9 / peak
    log(f"memory [{tag}] calibrated estimate {est:.3f} GB "
        f"(structure {estimate_train_hbm_gb(cfg):.3f} GB x "
        f"{memory.EAGER_FACTORS[memory.eager_mode(cfg)]}) vs measured peak "
        f"{peak / 1e9:.3f} GB: {ratio:.3f} (tol 0.75-1.25) {card}")
    if not 0.75 <= ratio <= 1.25:
        raise RuntimeError(f"memory [{tag}]: the calibrated estimate is "
                           f"{ratio:.3f} of the peak")
    return ratio


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
    with _FusedWarps() as fused:
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
    if launches['warp_mold'] < 1:
        raise RuntimeError(f"train [{tag}] never launched warp_mold")
    res['fused_err'] = check_fused_call(f"train [{tag}]", fused.first)
    del fused
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
    with _FusedWarps() as fused:
        eng.train(ds['train'], ds['val'], cfg.LEARNING_RATE, 2,
                  log_fn=lines.append)
    sync()
    out['fused_err'] = check_fused_call('engine (b)', fused.first, cuda)
    del fused
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

    # (d) streaming from disk: the host loader alone on each route, then
    # an epoch streamed through the native route
    out['cpu_count'] = os.cpu_count()
    out['loader_imgs_per_s'] = {}
    try:
        for route, native in (('native', True), ('python', False)):
            cfg.NATIVE_LOADER = native
            gen = loader.data_generator(ds['train'], cfg, shuffle=True,
                                        batch_size=cfg.BATCH_SIZE, seed=seed)
            next(gen)
            t0 = time.perf_counter()
            for _ in range(ENGINE_LOADER_BATCHES):
                next(gen)
            out['loader_imgs_per_s'][route] = (
                ENGINE_LOADER_BATCHES * cfg.BATCH_SIZE
                / (time.perf_counter() - t0))
            gen.close()
    finally:
        cfg.NATIVE_LOADER = True
    cfg.DATA_ON_DEVICE = False
    cfg.STEPS_PER_EPOCH = ENGINE_STREAM_STEPS
    lines = []
    try:
        with _NativeBatches() as native:
            eng2.train(ds['train'], ds['val'], cfg.LEARNING_RATE, 4,
                       log_fn=lines.append)
    finally:
        cfg.DATA_ON_DEVICE = 'auto'
        cfg.STEPS_PER_EPOCH = ENGINE_STEPS
    sync()
    out['warp_launches'] = warp_cuda.launches['warp_homography']
    out['warp_mold_launches'] = warp_cuda.launches['warp_mold']
    for line in lines:
        log(f"engine (d) {line}")
    check_native_batches('engine (d) streamed epoch', native)
    records = _records(eng2.log_dir)
    _check_epochs('(d)', records, range(4))
    out['streaming_imgs_per_s'] = records[3]['imgs_per_s']
    rates = out['loader_imgs_per_s']
    log(f"engine (d) host loader alone (decode PNG + resize + batch, "
        f"{ENGINE_LOADER_BATCHES} batches of {cfg.BATCH_SIZE}, "
        f"os.cpu_count() {out['cpu_count']}): native route (threads "
        f"min(batch, cpus)) {rates['native']:.2f} images/s, Python path "
        f"(NATIVE_LOADER False, one thread) {rates['python']:.2f} images/s; "
        f"epoch streamed through the native route ({ENGINE_STREAM_STEPS} "
        f"steps, from empty prefetch queues) {out['streaming_imgs_per_s']} "
        f"imgs/s vs resident {out['resident_imgs_per_s']} imgs/s (epochs "
        f"0-1, {ENGINE_STEPS} steps, the first with warm-up) {card}")
    log(f"engine (b)-(d) warp launches: {out['warp_launches']}, fused "
        f"(warp_mold) {out['warp_mold_launches']}")
    if cuda and out['warp_mold_launches'] < 1:
        raise RuntimeError("engine: the train path never launched warp_mold")

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
# phase 7: the command line

# The flagship's flags (benchmark_config(3): ResNet-50, branch 1024,
# 24³ orientation bins, bottleneck 128, 512×640, rotation augmentation).
CLI_FLAGS = ['--backbone', 'resnet50', '--bottleneck', '128',
             '--branch_size', '1024', '--ori_resolution', '24',
             '--classify_ori', '--regress_loc', '--rot_aug',
             '--rot_image_aug', '--image_scale', '0.5']
# bench.py's serving knobs beside the default `base` stem
CLI_S2D = ['--f16', '--set', 'QUANT_STEM_S2D=True', '--set',
           'QUANT_HOST_S2D=True']
CLI_TRAIN_STEPS = 4
CLI_EVAL_BATCH = 16   # the 32 test frames in two chunks
CLI_OVERLAYS = 10     # `test` draws 10 frames


class _Recorder:
    """While open, records what the evaluation loop served and returned
    (`evaluate._batched_forward`: engine, dataset, ids, raw heads;
    `evaluate.evaluate`: the summary, its seconds and the int8 calls of
    its served batches, not those of calibration) and times the h5
    bridge's writes and reads; restores the functions on close."""

    def __init__(self):
        from ursonet_torch.checkpoint import h5_import
        self.targets = [(evaluate, '_batched_forward'),
                        (evaluate, 'evaluate'),
                        (h5_import, 'save_keras_h5'),
                        (h5_import, 'load_keras_h5')]
        self.served, self.summaries, self.h5_s = [], [], {}
        self.eval_s, self.calls = None, []

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        fwd, ev, save, load = self.saved

        def batched_forward(engine, dataset, ids):
            out = fwd(engine, dataset, ids)
            self.served.append({'engine': engine, 'dataset': dataset,
                                'ids': list(ids), 'outputs': out})
            return out

        def evaluate_(*a, **kw):
            int8_cuda.calls = []
            t0 = time.perf_counter()
            try:
                self.summaries.append(ev(*a, **kw))
            finally:
                self.calls, int8_cuda.calls = int8_cuda.calls, None
            self.eval_s = time.perf_counter() - t0
            return self.summaries[-1]

        def timed(name, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.h5_s[name] = time.perf_counter() - t0
                return out
            return run

        for (m, n), fn in zip(self.targets, (
                batched_forward, evaluate_, timed('write', save),
                timed('read', load))):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.targets, self.saved):
            setattr(m, n, fn)


class _PlainServing:
    """An engine's int8 model served through its plain version."""

    def __init__(self, engine):
        self.config = engine.config
        self.serving = engine.serving

    def mold_inputs(self, images):
        return self.serving.mold_inputs(images)

    def predict_molded(self, molded):
        return self.serving.qmodel(self.serving.served_batch(molded),
                                   plain=True)


def _same_heads(tag, got: dict, want: dict) -> float:
    """Raises unless every raw head equals `want`'s; returns the largest
    absolute difference (0.0)."""
    if got.keys() != want.keys():
        raise RuntimeError(f"cli {tag}: heads {sorted(got)} vs "
                           f"{sorted(want)}")
    err = 0.0
    for k in want:
        if got[k].shape != want[k].shape:
            raise RuntimeError(f"cli {tag} {k}: {got[k].shape} vs "
                               f"{want[k].shape}")
        diff = int((got[k] != want[k]).sum())
        err = max(err, float(np.abs(got[k] - want[k]).max()))
        if diff:
            raise RuntimeError(f"cli {tag} {k}: {diff} of {want[k].size} "
                               f"raw head values differ, max abs {err}")
    return err


def run_cli(root, device, seed: int = 0, flags=CLI_FLAGS,
            train_batch: int = FLAGSHIP_BATCH, eval_batch: int = CLI_EVAL_BATCH,
            steps: int = CLI_TRAIN_STEPS, card: str = '', name: str = 'cli',
            served_calls: bool = False, float_only: bool = False) -> dict:
    """The README's quick start through `ursonet_torch.pose_estimator.main`
    on the URSO frames under `root/urso`: train; evaluate in float;
    evaluate --int8 on the `base` stem and with the s2d knobs under F16,
    each run's raw heads and summary equal to those of the same served
    batches through the plain version (and with `served_calls`, each
    distinct int8 call of them on fresh operands: check_served_calls);
    export (h5 and the int8 artifact); evaluate from the exported h5,
    equal to the float run bit for bit; test (overlays) and test --image.
    With `float_only`, train and the float evaluate alone.
    Each command must return 0; every launch counter is set to 0 before a
    command and read after it. `name` tags the log lines and names the
    run's directories under `root`. Returns the launches by kernel row,
    the seconds and rates."""
    from ursonet_torch import pose_estimator
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out_dir = os.path.join(root, f'{name}_out')
    logs = os.path.join(root, f'{name}_logs')
    common = ['--dataset', 'urso', '--data_dir', root, '--logs', logs,
              '--out_dir', out_dir, '--models_dir',
              os.path.join(root, 'models'), '--seed', str(seed)] + list(flags)
    res = {'seconds': {}, 'launches': {}, 'rows': Counter(),
           'imgs_per_s': {}}

    def cli(tag, *argv):
        warp_cuda.reset_counts()
        int8_cuda.reset_counts()
        t0 = time.perf_counter()
        with _Recorder() as rec:
            rc = pose_estimator.main(list(argv) + common, device=dev)
        sync()
        res['seconds'][tag] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"{name} {tag}: exit code {rc}")
        launches = {**warp_cuda.launches, **int8_cuda.launches}
        res['launches'][tag] = launches
        log(f"{name} [{tag}] {' '.join(argv)}: exit 0 in "
            f"{res['seconds'][tag]:.1f} s (host wall, model build and "
            f"weight load included), launches {launches} {card}")
        return rec, rec.calls, launches

    # 1. train
    with _FusedWarps() as fused:
        _, _, launches = cli('train', 'train', '--weights', 'none',
                             '--epochs', '1', '--steps_per_epoch',
                             str(steps), '--batch_size', str(train_batch))
    res['fused_err'] = check_fused_call(f'{name} train', fused.first, cuda)
    del fused
    records = _records(os.path.dirname(store.find_last(logs)))
    _check_epochs(f'{name} train', records, range(1))
    log(f"{name} [train] metrics.jsonl: {records[0]}")
    if cuda and launches['warp_mold'] < 1:
        raise RuntimeError(f"{name} train never launched warp_mold")
    for k in ('warp_homography', 'warp_mold'):
        res['rows'][k] += launches[k]

    # 2. evaluate: float, then int8 on the base stem and with the s2d
    # knobs under F16, each against the plain version
    evals = {}
    runs = (('evaluate', []), ('evaluate int8', ['--int8']),
            ('evaluate int8 s2d f16', ['--int8'] + CLI_S2D))
    for tag, extra in runs[:1] if float_only else runs:
        rec, calls, launches = cli(tag, 'evaluate', '--weights', 'last',
                                   '--eval_batch', str(eval_batch), *extra)
        (served,), (summary,) = rec.served, rec.summaries
        n = len(served['ids'])
        evals[tag] = {'outputs': served['outputs'], 'summary': summary}
        for csv in ('ori_err.csv', 'loc_err.csv', 'dists_err.csv'):
            with open(os.path.join(out_dir, csv)) as f:
                if len(f.read().splitlines()) != n + 1:
                    raise RuntimeError(f"{name} {tag}: {csv} lacks rows")
        res['imgs_per_s'][tag] = n / rec.eval_s
        log(f"{name} [{tag}] summary {summary}; {n} frames in "
            f"{rec.eval_s:.2f} s, {res['imgs_per_s'][tag]:.2f} images/s "
            f"through evaluate() (PNG decode, resize, mold, forward, decode, "
            f"CSVs; host wall), {n / res['seconds'][tag]:.2f} over the whole "
            f"command {card}")
        if not extra:
            continue
        want = ['gemm_s8', 'conv_s8'] + (['stem_s8'] if '--f16' in extra
                                         else [])
        if cuda:
            missed = [k for k in want if launches[k] < 1]
            if missed:
                raise RuntimeError(f"{name} {tag}: {missed} never launched")
            check_served_routes(f'{name} {tag}', calls)
            if served_calls:
                check_served_calls(f'{name} {tag}', calls, dev,
                                   np.random.RandomState(seed))
        mode = '' if '--f16' in extra else '_f32acc'
        res['rows'].update(launch_rows(launches, mode))
        # the same served batches through the plain version
        with _Recorder() as plain:
            evaluate.evaluate(_PlainServing(served['engine']),
                              served['dataset'],
                              out_dir=os.path.join(root, f'{name}_plain'),
                              log_fn=lambda *a: None)
        _same_heads(tag, served['outputs'], plain.served[0]['outputs'])
        if plain.summaries[0] != summary:
            raise RuntimeError(f"{name} {tag}: summary {summary} vs the plain "
                               f"version's {plain.summaries[0]}")
        log(f"{name} [{tag}] the raw heads of its {n} frames equal the plain "
            "version's on the same served batches (0 differing values), "
            "and so does the summary")
        del served, plain, rec
    if float_only:
        return res

    # 3. export, then evaluate from the exported h5. export --int8 runs
    # int8 products only in bias_correct's capture passes, which the CLI
    # runs by default for a classification head (apply_ptq_refinements)
    rec, _, launches = cli('export', 'export', '--weights', 'last',
                           '--int8', '--eval_batch', str(eval_batch))
    args = pose_estimator.build_parser().parse_args(
        ['export', '--weights', 'last'] + common)
    refined = not (args.regress_ori and args.regress_loc)
    if cuda and refined and min(launches['gemm_s8'], launches['conv_s8']) < 1:
        raise RuntimeError(f"{name} export --int8: launches {launches}")
    # calibration, bias_correct
    res['rows'].update(launch_rows(launches, '_f32acc'))
    h5 = os.path.join(out_dir, 'urso_weights.h5')
    artifact = os.path.join(out_dir, 'urso_int8.msgpack')
    if not (os.path.exists(h5) and os.path.exists(artifact)):
        raise RuntimeError(f"{name} export wrote {os.listdir(out_dir)}")
    res['h5_bytes'] = os.path.getsize(h5)
    res['h5_write_s'] = rec.h5_s['write']
    rec, _, _ = cli('evaluate h5', 'evaluate', '--weights', h5,
                    '--eval_batch', str(eval_batch))
    res['h5_read_s'] = rec.h5_s['read']
    _same_heads('evaluate h5', rec.served[0]['outputs'],
                evals['evaluate']['outputs'])
    if rec.summaries[0] != evals['evaluate']['summary']:
        raise RuntimeError(f"{name} evaluate h5: summary {rec.summaries[0]} vs "
                           f"--weights last's {evals['evaluate']['summary']}")
    del rec
    log(f"{name} [export] h5 of {res['h5_bytes']} bytes written in "
        f"{res['h5_write_s']:.2f} s and read in {res['h5_read_s']:.2f} s "
        f"(the port's HDF5 codec, host), int8 artifact "
        f"{os.path.getsize(artifact)} bytes; evaluate --weights <h5> gives "
        f"--weights last's raw heads bit for bit and its summary {card}")

    # 4. test: overlays of 10 frames, then of one
    cli('test', 'test', '--weights', 'last', '--eval_batch', str(eval_batch))
    overlays = sorted(os.listdir(os.path.join(out_dir, 'overlays')))
    if len(overlays) != min(CLI_OVERLAYS, n):     # n: the test frames
        raise RuntimeError(f"{name} test: {len(overlays)} overlays")
    with open(os.path.join(out_dir, 'overlays', overlays[0]), 'rb') as f:
        shape = png.decode_png(f.read()).shape
    cli('test image', 'test', '--weights', 'last', '--image',
        os.path.join(root, 'urso', '0_rgb.png'))
    if not os.path.exists(os.path.join(out_dir, 'single_image_pose.png')):
        raise RuntimeError(f"{name} test --image wrote no overlay")
    log(f"{name} [test] {len(overlays)} overlays of {shape}, and "
        "single_image_pose.png")
    return res


# --------------------------------------------------------------------------
# phase 8: SPEED, benchmark config 4

# Gray SPEED frames at the camera's 1920x1200, written by the port's JPEG
# encoder; the engine runs 2 epochs of SPEED_STEPS steps + 1 validation
# step in each sim2real order.
SPEED_FRAMES = {'train_no_val': 32, 'val': 8, 'test': 8, 'real_test': 8}
SPEED_WH = (1920, 1200)
SPEED_STEPS = 4
# CLR's step size on the card (the preset's is 4000): the learning rate
# rises for 3 updates and falls for 3, so 8 updates cross a peak and a
# trough of the cycle.
SPEED_CLR_STEP = 3
# config 4 through the command line: ResNet-50, bottleneck 128, 16^3
# bins, 640x960 (--image_scale 0.5), sim2real, CLR, rotations
SPEED_CLI_FLAGS = ['--backbone', 'resnet50', '--bottleneck', '128',
                   '--branch_size', '1024', '--ori_resolution', '16',
                   '--classify_ori', '--regress_loc', '--image_scale', '0.5',
                   '--sim2real', '--clr', '--rot_aug', '--rot_image_aug']
SPEED_EVAL_BATCH = 8


def speed_config(cfg=None, per_image_order: bool = False,
                 optimizer: str = 'SGD') -> Config:
    """benchmark_config(4) (or `cfg`) with the phase's schedule: sim2real
    in the given order, `optimizer`, CLR over SPEED_CLR_STEP updates."""
    cfg = cfg or presets.benchmark_config(4)
    cfg.SIM2REAL_AUG = True
    cfg.CLR = True
    cfg.SIM2REAL_PER_IMAGE_ORDER = per_image_order
    cfg.OPTIMIZER = optimizer
    cfg.CLR_STEP_SIZE = SPEED_CLR_STEP
    cfg.STEPS_PER_EPOCH = SPEED_STEPS
    cfg.VALIDATION_STEPS = 1
    cfg.update()
    return cfg


def clr_numpy(count: int, base: float, top: float, step: int) -> float:
    """The triangular cyclical learning rate, float64."""
    cycle = np.floor(1 + count / (2 * step))
    x = abs(count / step - 2 * cycle + 1)
    return base + (top - base) * max(0.0, 1 - x)


def _record_lrs(eng) -> list:
    """The learning rate of every update the engine's optimizer makes
    from now on."""
    lrs, step = [], eng.tx.step

    def recorded(*args):
        step(*args)
        lrs.append(eng.tx.last_lr)
    eng.tx.step = recorded
    return lrs


def _check_clr(tag, cfg, lrs, first: int = 0) -> None:
    want = [clr_numpy(first + i, cfg.BASE_LEARNING_RATE,
                      cfg.MAX_LEARNING_RATE, cfg.CLR_STEP_SIZE)
            for i in range(len(lrs))]
    if not lrs or not np.allclose(lrs, want, rtol=1e-6, atol=0):
        raise RuntimeError(f"speed {tag}: learning rates {lrs} vs the "
                           f"cyclical schedule's {want}")


class _Preprocessed:
    """While open, keeps the pixels (images plus the mean pixel) of the
    first batch a `DevicePreprocess` returns."""

    def __enter__(self):
        self.saved = loader.DevicePreprocess.__call__
        self.first = None

        def recorded(pre, raw, draws=None):
            batch = self.saved(pre, raw, draws)
            if self.first is None:
                self.first = (batch['images'] + pre.mean_pixel).detach()
            return batch
        loader.DevicePreprocess.__call__ = recorded
        return self

    def __exit__(self, *exc):
        loader.DevicePreprocess.__call__ = self.saved


def _speed_datasets(root, cfg, subsets):
    from ursonet_torch.data.speed import Speed
    out = {}
    for subset in subsets:
        out[subset] = Speed()
        out[subset].load_dataset(root, cfg, subset)
    return out


def _submission_rows(out_dir, ds) -> list:
    """The rows of the one submission in `out_dir`, checked: test frames
    then real_test frames, each sorted by name, unit quaternions."""
    import csv as csv_mod
    files = [f for f in os.listdir(out_dir) if f.startswith('submission_')]
    if len(files) != 1:
        raise RuntimeError(f"speed submit: {files} in {out_dir}")
    with open(os.path.join(out_dir, files[0]), newline='') as f:
        rows = list(csv_mod.reader(f))
    want = [sorted(os.path.basename(i['path']) for i in ds[s].image_info)
            for s in ('test', 'real_test')]
    if [r[0] for r in rows] != want[0] + want[1]:
        raise RuntimeError(f"speed submit: rows {[r[0] for r in rows]}")
    vals = np.array([r[1:] for r in rows], np.float64)
    if vals.shape[1] != 7 or not np.isfinite(vals).all() or not np.allclose(
            np.linalg.norm(vals[:, :4], axis=1), 1.0, atol=1e-5):
        raise RuntimeError(f"speed submit: values {vals}")
    return rows


def run_speed(root, device, seed: int = 0, frames=None, wh=SPEED_WH,
              cfg_fn=None, cli_flags=SPEED_CLI_FLAGS, train_batch: int = 4,
              eval_batch: int = SPEED_EVAL_BATCH, steps: int = SPEED_STEPS,
              card: str = '') -> dict:
    """The SPEED phase: (a) `make_speed_dataset` writes gray JPEG frames;
    (b) `UrsoNet.train` trains config 4 (`speed_config`) 2 epochs in each
    sim2real order, each update's learning rate the cyclical schedule's,
    the first preprocessed train batch gray; (c) the command line trains
    config 4 (the gray warp launched, one call equal to the plain
    version); (d) `evaluate` on val (finite ESA) and `submit` in float and
    --int8 (gemm_s8 and conv_s8 on their TMA routes, each distinct call
    and the served raw heads equal to the plain version); (e) an Adam +
    CLR run resumed bit for bit, then trained on. `cfg_fn(per_image_order,
    optimizer)` makes the engine's configs (default `speed_config`).
    Every launch counter is set to 0 before each part and read after it.
    Returns the launches by kernel row, seconds, timings and the int8
    submit's largest difference from the plain version (`max_abs_err`)."""
    from ursonet_torch import pose_estimator, submission
    from ursonet_torch.data import jpeg
    from ursonet_torch.data.synthetic import make_speed_dataset
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg_fn = cfg_fn or (lambda order, opt: speed_config(
        per_image_order=order, optimizer=opt))
    frames = frames or SPEED_FRAMES
    res = {'seconds': {}, 'rows': Counter(), 'launches': {},
           'fused_err': 0.0}
    data = os.path.join(root, 'speed')

    def fused_call(tag, first):
        res['fused_err'] = max(res['fused_err'], check_fused_call(
            f'speed {tag}', first, cuda))

    def part(tag):
        sync()
        warp_cuda.reset_counts()
        int8_cuda.reset_counts()
        res['seconds'][tag] = time.perf_counter()

    def done(tag):
        sync()
        res['seconds'][tag] = time.perf_counter() - res['seconds'][tag]
        launches = {**warp_cuda.launches, **int8_cuda.launches}
        res['launches'][tag] = launches
        for k in ('warp_homography', 'warp_homography_gray', 'warp_mold'):
            res['rows'][k] += launches[k]
        log(f"speed [{tag}] {res['seconds'][tag]:.1f} s (host wall), "
            f"launches {launches} {card}")
        return launches

    # (a) frames
    part('frames')
    make_speed_dataset(data, n_per_subset=frames, width=wh[0],
                       height=wh[1], seed=seed)
    done('frames')
    path = os.path.join(data, 'images', 'train', 'img000000.jpg')
    with open(path, 'rb') as f:
        blob = f.read()
    t0 = time.perf_counter()
    gray = jpeg.decode_jpeg(blob)
    res['decode_ms'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    jpeg.encode_jpeg(gray)
    res['encode_ms'] = (time.perf_counter() - t0) * 1e3
    if gray.shape != (wh[1], wh[0]):
        raise RuntimeError(f"speed (a): frame of {gray.shape}")
    log(f"speed (a) {sum(frames.values())} gray JPEG frames at {wh[0]}x{wh[1]} "
        f"in {res['seconds']['frames']:.1f} s; one frame ({len(blob)} bytes): "
        f"decode {res['decode_ms']:.1f} ms, encode {res['encode_ms']:.1f} ms "
        "(the port's codec, one host thread)")
    # one batch of frames through the native loader at config 4's geometry
    cfg = cfg_fn(False, 'SGD')
    ds = _speed_datasets(data, cfg, ('train_no_val',))['train_no_val']
    g = loader.native_geometry(ds, cfg)
    paths = [ds.image_info[i]['path']
             for i in range(min(cfg.BATCH_SIZE, len(ds.image_ids)))]
    geom = (g['out_h'], g['out_w'], g['content_h'], g['content_w'],
            g['top'], g['left'])
    t0 = time.perf_counter()
    got = native_loader.load_batch(paths, *geom)
    res['native_batch_ms'] = (time.perf_counter() - t0) * 1e3
    diff = int((got != native_loader.load_batch_plain(paths, *geom)).sum())
    if diff:
        raise RuntimeError(f"speed (a): the native JPEG batch differs from "
                           f"load_batch_plain in {diff} values")
    log(f"speed (a) native loader: {len(paths)} gray {wh[0]}x{wh[1]} JPEGs "
        f"-> {tuple(got.shape)} in {res['native_batch_ms']:.1f} ms (host), "
        "equal to load_batch_plain bit for bit")

    # (b) the engine trains config 4 in each sim2real order
    for order in (False, True):
        tag = f"engine per_image_order={order}"
        cfg = cfg_fn(order, 'SGD')
        ds = _speed_datasets(data, cfg, ('train_no_val', 'val'))
        part(tag)
        eng = UrsoNet('training', cfg,
                      os.path.join(root, f'speed_logs_{int(order)}'),
                      device=dev)
        eng.initialize(seed)
        lrs = _record_lrs(eng)
        lines = []
        with _Preprocessed() as pre, _FusedWarps() as fused:
            eng.train(ds['train_no_val'], ds['val'], cfg.LEARNING_RATE, 2,
                      log_fn=lines.append)
        launches = done(tag)
        fused_call(f'(b) {tag}', fused.first)
        del fused
        for line in lines:
            log(f"speed (b) [{tag}] {line}")
        _check_epochs(f'speed (b) {tag}', _records(eng.log_dir), range(2))
        _check_clr(f'(b) {tag}', cfg, lrs)
        log(f"speed (b) [{tag}] learning rates {lrs} = the cyclical "
            f"schedule's (base {cfg.BASE_LEARNING_RATE}, max "
            f"{cfg.MAX_LEARNING_RATE}, step {cfg.CLR_STEP_SIZE})")
        if cuda and min(launches['warp_homography_gray'],
                        launches['warp_mold']) < 1:
            raise RuntimeError(f"speed (b) {tag}: the fused gray warp never "
                               f"ran: {launches}")
        # the first batch it trained on, preprocessed: three equal channels
        pix = pre.first
        spread = float((pix - pix[:, :1]).abs().max())
        if spread > 1e-3:
            raise RuntimeError(f"speed (b) {tag}: channels differ by {spread}")
        log(f"speed (b) [{tag}] first preprocessed train batch "
            f"{tuple(pix.shape)}: the three channels agree within {spread} "
            "(the mean pixel's rounding)")
        del eng, pre, pix
    if cuda:
        torch.cuda.empty_cache()

    # (c)-(d) the command line
    logs = os.path.join(root, 'speed_cli_logs')
    common = ['--dataset', 'speed', '--data_dir', root, '--logs', logs,
              '--models_dir', os.path.join(root, 'models'), '--seed',
              str(seed)] + list(cli_flags)

    def cli(tag, *argv, out_dir=None):
        out_dir = out_dir or os.path.join(root, 'speed_out')
        os.makedirs(out_dir, exist_ok=True)
        part(tag)
        rc = pose_estimator.main(list(argv) + common + ['--out_dir', out_dir],
                                 device=dev)
        if rc != 0:
            raise RuntimeError(f"speed cli {tag}: exit code {rc}")
        return done(tag)

    with _FusedWarps() as fused:
        launches = cli('cli train', 'train', '--weights', 'none', '--epochs',
                       '1', '--steps_per_epoch', str(steps), '--batch_size',
                       str(train_batch), '--set', 'VALIDATION_STEPS=1')
    _check_epochs('speed (c)', _records(os.path.dirname(
        store.find_last(logs))), range(1))
    if cuda and min(launches['warp_homography_gray'],
                    launches['warp_mold']) < 1:
        raise RuntimeError("speed (c): the CLI's training never launched "
                           f"the fused gray warp: {launches}")
    fused_call('(c)', fused.first)
    del fused

    with _Recorder() as rec:
        cli('cli evaluate', 'evaluate', '--weights', 'last', '--eval_batch',
            str(eval_batch))
    (summary,) = rec.summaries
    if not all(np.isfinite(v) for v in summary.values()):
        raise RuntimeError(f"speed (d) evaluate: summary {summary}")
    res['evaluate'] = summary
    log(f"speed (d) evaluate on val: {summary}")

    cfg = cfg_fn(False, 'SGD')
    ds = _speed_datasets(data, cfg, ('test', 'real_test'))
    served = []
    run = submission.test_and_submit

    def recorded(*a, **kw):
        int8_cuda.calls = []
        try:
            return run(*a, **kw)
        finally:
            served.append(int8_cuda.calls)
            int8_cuda.calls = None
    submission.test_and_submit = recorded
    try:
        for tag, extra in (('cli submit', []), ('cli submit int8',
                                                ['--int8'])):
            out_dir = os.path.join(root, tag.replace(' ', '_'))
            with _Recorder() as rec:
                launches = cli(tag, 'submit', '--weights', 'last',
                               '--eval_batch', str(eval_batch), *extra,
                               out_dir=out_dir)
            rows = _submission_rows(out_dir, ds)
            log(f"speed (d) [{tag}] {len(rows)} rows, test then real_test, "
                f"each sorted; first {rows[0]}")
            if not extra:
                continue
            calls = served[-1]
            if cuda:
                if min(launches['gemm_s8'], launches['conv_s8']) < 1:
                    raise RuntimeError(f"speed {tag}: launches {launches}")
                check_served_routes(f'speed {tag}', calls)
                modes = Counter(a['acc'] for _, a in calls)
                if set(modes) != {'f32'}:
                    raise RuntimeError(f"speed {tag}: launches in modes "
                                       f"{modes}")
                check_served_calls(f'speed {tag}', calls, dev,
                                   np.random.RandomState(seed))
            res['rows'].update(launch_rows(launches, '_f32acc'))
            # the served batches of both test sets through the plain version
            if len(rec.served) != 2:
                raise RuntimeError(f"speed {tag}: {len(rec.served)} served "
                                   "sets, not test and real_test")
            res['max_abs_err'] = 0.0
            for batch in rec.served:
                plain = evaluate._batched_forward(
                    _PlainServing(batch['engine']), batch['dataset'],
                    batch['ids'])
                res['max_abs_err'] = max(res['max_abs_err'], _same_heads(
                    f'speed {tag}', batch['outputs'], plain))
            log(f"speed (d) [{tag}] the raw heads of its {len(rows)} frames "
                f"({len(rec.served)} served sets) equal the plain version's "
                f"on the same served batches: max abs "
                f"{res['max_abs_err']}")
            del rec, batch, plain
    finally:
        submission.test_and_submit = run

    # (e) Adam + CLR: a run, its resume bit for bit, one more epoch
    cfg = cfg_fn(False, 'ADAM')
    cfg.STEPS_PER_EPOCH = 2
    ds = _speed_datasets(data, cfg, ('train_no_val', 'val'))
    part('adam')
    model_dir = os.path.join(root, 'speed_adam')
    eng = UrsoNet('training', cfg, model_dir, device=dev)
    eng.initialize(seed)
    with _FusedWarps() as fused:
        eng.train(ds['train_no_val'], ds['val'], cfg.LEARNING_RATE, 1,
                  log_fn=lambda *a: None)
    fused_call('(e) adam', fused.first)
    del fused
    eng2 = UrsoNet('training', cfg, model_dir, device=dev)
    if not eng2.resume_state(eng.log_dir):
        raise RuntimeError("speed (e): no state to resume")
    _same_tensors('speed (e) params', eng2.model.state_dict(),
                  eng.model.state_dict())
    for slot in ('mu', 'nu', 'nu_max'):
        _same_tensors(f'speed (e) {slot}', eng2.slots[slot], eng.slots[slot])
    if (eng2.tx.count, eng2.step, eng2.epoch) != (eng.tx.count, eng.step, 1):
        raise RuntimeError(f"speed (e): count/step/epoch {eng2.tx.count}/"
                           f"{eng2.step}/{eng2.epoch}")
    lrs = _record_lrs(eng2)
    eng2.train(ds['train_no_val'], ds['val'], cfg.LEARNING_RATE, 2,
               log_fn=lambda *a: None)
    done('adam')
    _check_epochs('speed (e)', _records(eng.log_dir), range(2))
    _check_clr('(e)', cfg, lrs, first=eng.tx.count)
    log(f"speed (e) Adam + CLR resumed bit for bit (params, mu, nu, nu_max, "
        f"count {eng.tx.count}); the next epoch's learning rates {lrs}")
    del eng, eng2
    return res


# --------------------------------------------------------------------------
# phase 8b: benchmark config 2 (ResNet-18, quaternion regression, batch 1)

# benchmark_config(2)'s flags (ResNet-18, bottleneck 32, location and
# quaternion regression, 512x640, the default rotation augmentation),
# streamed from disk (DATA_ON_DEVICE False) so that the training frames go
# through the native loader.
CONFIG2_FLAGS = ['--backbone', 'resnet18', '--bottleneck', '32',
                 '--regress_loc', '--regress_ori', '--ori_param',
                 'quaternion', '--ori_resolution', '32', '--rot_aug',
                 '--image_scale', '0.5', '--set', 'DATA_ON_DEVICE=False']
CONFIG2_STEPS = 8


def config2(backbone: str = 'resnet18') -> Config:
    """benchmark_config(2), on `backbone`."""
    cfg = presets.benchmark_config(2)
    cfg.BACKBONE = backbone
    cfg.update()
    return cfg


def run_config2(root, device, seed: int = 0, flags=CONFIG2_FLAGS,
                steps: int = CONFIG2_STEPS, cfg_fn=config2,
                card: str = '') -> dict:
    """Benchmark config 2 on the URSO frames under `root/urso`: (a) the
    command line (`run_cli` at batch 1: train `steps` steps streamed
    through the native loader, its first batches equal to
    load_batch_plain; evaluate in float, --int8 with f32 epilogues and
    with --f16 and the s2d knobs, each distinct served int8 call and the
    raw heads equal to the plain version; export and evaluate the h5;
    test); (b) one ResNet-18 train step of `cfg_fn('resnet18')`, its
    peak memory beside check_train_memory's estimate; (c) one ResNet-34
    train step and one int8 served batch (f32 epilogues: gemm_s8 and
    conv_s8 launched, each distinct call and the batch equal to the
    plain version). Returns the launches by kernel row, seconds and
    rates."""
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    # (a) the command line
    with _NativeBatches() as native:
        out['cli'] = run_cli(root, dev, seed, flags=flags, train_batch=1,
                             eval_batch=1, steps=steps, card=card,
                             name='config2', served_calls=True)
    if native.count < steps:
        raise RuntimeError(f"config2 train: {native.count} native batches "
                           f"for {steps} steps")
    check_native_batches('config2 train', native)
    rows = Counter(out['cli']['rows'])

    # (b) a ResNet-18 step: peak memory beside the estimate, counted from
    # what earlier phases still hold when the model is built
    cfg = cfg_fn('resnet18')
    sync()
    held = torch.cuda.memory_allocated() if cuda else 0
    res = run_main_path(cfg, dev, seed, steps=1)
    for m in res['train'] + [res['val']]:
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"config2 resnet18 step: metrics {m}")
    out['peak'] = step_peak(res, seed) - held if cuda else 0
    out['estimate_gb'] = check_train_memory(cfg, dev, log)
    log(f"config2 (b) resnet18 train step at batch {cfg.BATCH_SIZE} "
        f"{cfg.IMAGE_SHAPE[0]}x{cfg.IMAGE_SHAPE[1]}: loss "
        f"{res['train'][0]['loss']:.6f}; check_train_memory estimate "
        f"{out['estimate_gb']:.3f} GB (structure "
        f"{estimate_train_hbm_gb(cfg):.3f} GB x "
        f"{memory.EAGER_FACTORS[memory.eager_mode(cfg)]}) vs measured peak "
        f"{out['peak']} bytes ({out['peak'] / 1e9:.3f} GB) in one step, "
        f"above the {held} bytes held before the model was built {card}")
    del res

    # (c) ResNet-34: a train step and an int8 served batch
    cfg = cfg_fn('resnet34')
    warp_cuda.reset_counts()
    res = run_main_path(cfg, dev, seed, steps=1)
    sync()
    for m in res['train'] + [res['val']]:
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"config2 resnet34 step: metrics {m}")
    rows['warp_mold'] += warp_cuda.launches['warp_mold']
    rows['warp_homography'] += warp_cuda.launches['warp_homography']
    log(f"config2 (c) resnet34 train step: loss "
        f"{res['train'][0]['loss']:.6f}, validation {res['val']}")
    rng = np.random.RandomState(seed)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    images = rng.randint(0, 256, (cfg.BATCH_SIZE, h, w, 3), np.uint8)
    engine = ServingEngine(cfg, dev, model=res['model'])
    qm = engine.quantize()
    qm.calibrate(images)
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    served = engine.predict_molded(images)
    sync()
    launches, calls = dict(int8_cuda.launches), int8_cuda.calls
    int8_cuda.calls = None
    log(f"config2 (c) resnet34 int8 served batch of {cfg.BATCH_SIZE}: "
        f"launches {launches}")
    if cuda:
        if min(launches['gemm_s8'], launches['conv_s8']) < 1:
            raise RuntimeError(f"config2 resnet34 serve: {launches}")
        check_served_routes('config2 resnet34', calls)
        check_served_calls('config2 resnet34', calls, dev, rng)
    rows.update(launch_rows(launches, '_f32acc'))
    plain = qm(images, plain=True)
    for k, v in served.items():
        diff = int((v != plain[k]).sum())
        if diff or not torch.isfinite(v).all():
            raise RuntimeError(f"config2 resnet34 serve {k}: {diff} values "
                               "differ from the plain version")
    log("config2 (c) resnet34 served heads equal the plain version's (0 "
        "differing values)")
    out['rows'] = rows
    return out


# --------------------------------------------------------------------------
# phase 8c: batch-statistics BN (TRAIN_BN None / True), the host-parity
# generator (--host_augment) and DEBUG_NANS

TRAINBN_CALIB = 8     # frames the TRAIN_BN=None model is quantized on
HOST_STEPS = 4        # train --host_augment steps, at the flagship's batch
HOST_LOADER_BATCHES = 2   # host-parity batches timed alone


def with_train_bn(cfg, train_bn=None) -> Config:
    cfg.TRAIN_BN = train_bn
    cfg.update()
    return cfg


def bn_layers(model) -> dict:
    """{module name: FrozenBN} of a model."""
    return {n: m for n, m in model.named_modules()
            if isinstance(m, FrozenBN)}


def running_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}


def check_stats_trained(tag, model) -> int:
    """Every batch norm's running statistics finite and moved from the
    initialization (mean 0, variance 1); returns the layer count."""
    layers = bn_layers(model)
    for name, m in layers.items():
        if not (torch.isfinite(m.running_mean).all()
                and torch.isfinite(m.running_var).all()):
            raise RuntimeError(f"{tag}: {name}'s running statistics are not "
                               "finite")
        if bool((m.running_var == 1).all()) and not m.running_mean.any():
            raise RuntimeError(f"{tag}: {name}'s running statistics never "
                               "moved")
    return len(layers)


def trainbn_path(dev, cfg, tag, seed, card, ref_ms=None) -> dict:
    """(a) `cfg` under TRAIN_BN=None: STEPS steps + 1 validation step
    with the launch counts read around them (losses finite and falling,
    the fused warp launched, its first call equal to the plain chain),
    every BN's running statistics moved; on the card the step time beside
    `ref_ms` (phase 4/5's step of this run) and one step's peak, counted
    above what the process held before the model was built, beside
    check_train_memory's estimate (uncalibrated: printed, not gated)."""
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
    # what earlier phases (and the f32 model kept for (d)) still hold
    held = torch.cuda.memory_allocated() if cuda else 0
    warp_cuda.reset_counts()
    with _FusedWarps() as fused:
        res = run_main_path(cfg, dev, seed, STEPS)
    if cuda:
        torch.cuda.synchronize()
    res['launches'] = dict(warp_cuda.launches)
    log(f"trainbn [{tag}] losses: "
        + " ".join(f"{m['loss']:.6f}" for m in res['train'])
        + f"; validation {res['val']['loss']:.6f}; launches "
        f"{res['launches']}")
    check_main_path(res)
    if cuda and res['launches']['warp_mold'] < 1:
        raise RuntimeError(f"trainbn [{tag}] never launched warp_mold")
    res['fused_err'] = check_fused_call(f"trainbn [{tag}]", fused.first, cuda)
    del fused
    n = check_stats_trained(f"trainbn [{tag}]", res['model'])
    log(f"trainbn [{tag}] the running statistics of all {n} batch norms "
        "moved and are finite")
    res['ms'] = res['peak'] = None
    res['estimate_gb'] = check_train_memory(cfg, dev, log)
    if cuda:
        res['ms'] = time_train(res, seed)
        res['peak'] = step_peak(res, seed) - held
        b = cfg.BATCH_SIZE
        ref = f" vs {ref_ms:.3f} ms with frozen BN in this run" \
            if ref_ms else ""
        log(f"trainbn [{tag}] step: median {res['ms']:.3f} ms over 10 steps "
            f"after 2 warm-up, {b / res['ms'] * 1e3:.2f} imgs/s{ref}, batch "
            f"{b} {cfg.IMAGE_SHAPE[0]}x{cfg.IMAGE_SHAPE[1]} {card}")
        log(f"trainbn [{tag}] peak memory in one step {res['peak']} bytes "
            f"({res['peak'] / 2**30:.2f} GiB) above the {held} bytes held "
            f"before the model was built, vs check_train_memory's "
            f"uncalibrated estimate {res['estimate_gb']:.3f} GB: "
            f"{res['estimate_gb'] * 1e9 / res['peak']:.3f} {card}")
    return res


def remat_stats_equal(dev, cfg, seed) -> dict:
    """(b) `cfg` (config 5) under TRAIN_BN=None: one train step with
    REMAT and one without, each on a fresh model from the same seed, on
    the same raw batch and draws; the running statistics must be equal
    bit for bit (a recomputed block must not update twice). Returns the
    warp's launches and the tensor count."""
    raw = make_raw_batch(cfg, seed)
    stats, launches = {}, Counter()
    for remat in (cfg.REMAT or True, False):
        c = copy.copy(cfg)
        c.REMAT = remat
        model = build_model(c, dev, torch.Generator().manual_seed(seed))
        step = make_train_step(model, c, make_optimizer(c),
                               preprocess=make_device_preprocess(
                                   c, device=dev), device=dev)
        warp_cuda.reset_counts()
        m = step(raw, torch.Generator().manual_seed(seed + 1))
        launches.update(warp_cuda.launches)
        if not np.isfinite(float(m['loss'])):
            raise RuntimeError(f"trainbn [config5 REMAT={remat}]: loss "
                               f"{float(m['loss'])}")
        stats[remat] = running_stats(model)
        del model, step
    a, b = stats.values()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ:
        raise RuntimeError(f"trainbn [config5]: REMAT changed the running "
                           f"statistics of {len(differ)} tensors: "
                           f"{differ[:4]}")
    return {'launches': launches, 'tensors': len(a)}


def run_trainbn(root, device, seed: int = 0, card: str = '',
                cfg_fn=flagship_config, cfg5=None, cfg2=None,
                flags=CLI_FLAGS, train_batch: int = FLAGSHIP_BATCH,
                host_steps: int = HOST_STEPS, ref_ms=None) -> dict:
    """Phase 8c on the URSO frames under `root/urso`:
    (a) `cfg_fn(f16)` under TRAIN_BN=None, f32 and F16 (trainbn_path);
    (b) config 5 under TRAIN_BN=None, REMAT against none
    (remat_stats_equal); (c) `cfg2` (config 2, batch 1) under
    TRAIN_BN=True: one step with the head BNs at one value per channel,
    finite; (d) (a)'s f32 model quantized on TRAINBN_CALIB frames and
    served: gemm_s8 and conv_s8 on their TMA routes, each distinct call
    and the served batch equal to the plain version bit for bit; (e) the
    command line's `train --host_augment` at `flags` (`host_steps` steps
    at `train_batch`): finite losses, warp_mold launched 0 times, the
    host-parity generator's images/s alone beside the step's; (f)
    DEBUG_NANS raising FloatingPointError on a NaN batch. Returns the
    launches by kernel row, step times, peaks and rates."""
    from ursonet_torch import pose_estimator
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ref_ms = ref_ms or {}
    out = {'rows': Counter(), 'fused_err': 0.0}
    rows = out['rows']

    # (a) the flagship, f32 and F16
    for f16 in (False, True):
        mode = 'f16' if f16 else 'f32'
        res = trainbn_path(dev, with_train_bn(cfg_fn(f16)), f'{mode} flagship',
                           seed, card, ref_ms.get(mode))
        out[mode] = {k: res[k] for k in ('ms', 'peak', 'estimate_gb')}
        out['fused_err'] = max(out['fused_err'], res['fused_err'])
        for k in ('warp_homography', 'warp_mold'):
            rows[k] += res['launches'][k]
        if not f16:
            model32, cfg32 = res['model'], with_train_bn(cfg_fn(False))
        del res
    if cuda:
        torch.cuda.empty_cache()

    # (b) config 5: the running statistics with and without REMAT
    cfg5 = with_train_bn(cfg5 or presets.benchmark_config(5))
    b = remat_stats_equal(dev, cfg5, seed)
    for k in ('warp_homography', 'warp_mold'):
        rows[k] += b['launches'][k]
    if cuda and b['launches']['warp_mold'] < 2:
        raise RuntimeError(f"trainbn [config5] warp launches {b['launches']}")
    log(f"trainbn [config5 REMAT={cfg5.REMAT or True} vs none] one step each "
        f"from the same weights and batch: the {b['tensors']} running "
        "statistics tensors equal bit for bit")

    # (c) config 2 under TRAIN_BN=True at batch 1
    cfg2 = with_train_bn(cfg2 or presets.benchmark_config(2), True)
    warp_cuda.reset_counts()
    res = run_main_path(cfg2, dev, seed, steps=2)
    sync()
    for k in ('warp_homography', 'warp_mold'):
        rows[k] += warp_cuda.launches[k]
    for m in res['train'] + [res['val']]:
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"trainbn [config2 TRAIN_BN=True]: {m}")
    heads = {n: m for n, m in bn_layers(res['model']).items()
             if '_head.' in n}
    if sorted(n.split('.')[-1] for n in heads) != ['loc_bn_0', 'ori_bn_0']:
        raise RuntimeError(f"trainbn [config2]: head BNs {sorted(heads)}")
    check_stats_trained('trainbn [config2 TRAIN_BN=True]', res['model'])
    log(f"trainbn [config2 TRAIN_BN=True] batch {cfg2.BATCH_SIZE}: losses "
        + " ".join(f"{m['loss']:.6f}" for m in res['train'])
        + f", validation {res['val']['loss']:.6f}; head BNs "
        + ", ".join(f"{n} running_var[:3] {m.running_var[:3].tolist()}"
                    for n, m in heads.items()) + " (finite)")
    del res

    # (d) the TRAIN_BN=None model quantized and served
    rng = np.random.RandomState(seed)
    images = make_raw_batch(cfg32, seed + 5)['images_u8']
    engine = ServingEngine(cfg32, dev, model=model32)
    engine.quantize(list(images[:TRAINBN_CALIB]))
    molded, _, _ = engine.mold_inputs(list(images))
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    served = engine.predict_molded(molded)
    sync()
    launches, calls = dict(int8_cuda.launches), int8_cuda.calls
    int8_cuda.calls = None
    log(f"trainbn [serve] TRAIN_BN=None model quantized on {TRAINBN_CALIB} "
        f"frames, served batch of {len(images)}: launches {launches}")
    if cuda:
        if min(launches['gemm_s8'], launches['conv_s8']) < 1:
            raise RuntimeError(f"trainbn serve: launches {launches}")
        check_served_routes('trainbn serve', calls)
        check_served_calls('trainbn serve', calls, dev, rng)
    mode = ACC_NAMES[engine.qmodel.acc_dtype]
    sfx = '' if mode == 'bf16' else '_f32acc'
    rows.update(launch_rows(launches, sfx))
    rows[C2_REQUANT + sfx] += sum(1 for n, a in calls if n == 'gemm_s8'
                                  and a.get('epilogue') == 'q8_relu')
    plain = engine.qmodel(engine.served_batch(molded), plain=True)
    for k, v in served.items():
        diff = int((v != plain[k]).sum())
        if diff or not torch.isfinite(v).all():
            raise RuntimeError(f"trainbn serve {k}: {diff} values differ "
                               "from the plain version")
    log("trainbn [serve] the served heads equal the plain version's (0 "
        "differing values)")
    del engine, model32, served, plain
    if cuda:
        torch.cuda.empty_cache()

    # (e) train --host_augment through the command line
    logs = os.path.join(root, 'trainbn_logs')
    argv = (['train', '--dataset', 'urso', '--data_dir', root, '--logs',
             logs, '--out_dir', os.path.join(root, 'trainbn_out'),
             '--models_dir', os.path.join(root, 'models'), '--weights',
             'none', '--epochs', '1', '--steps_per_epoch', str(host_steps),
             '--batch_size', str(train_batch), '--seed', str(seed),
             '--host_augment', '--set', 'VALIDATION_STEPS=1']
            + list(flags))
    warp_cuda.reset_counts()
    t0 = time.perf_counter()
    rc = pose_estimator.main(argv, device=dev)
    sync()
    seconds = time.perf_counter() - t0
    warps = dict(warp_cuda.launches)
    if rc != 0:
        raise RuntimeError(f"trainbn train --host_augment: exit code {rc}")
    if any(warps.values()):
        raise RuntimeError(f"trainbn train --host_augment launched the warp: "
                           f"{warps}")
    records = _records(os.path.dirname(store.find_last(logs)))
    _check_epochs('trainbn train --host_augment', records, range(1))
    out['host_epoch_ips'] = records[0]['imgs_per_s']
    log(f"trainbn [train --host_augment] exit 0 in {seconds:.1f} s (host "
        f"wall), warp launches {warps}; metrics.jsonl {records[0]} {card}")
    # the generator alone, and the step alone on its batches
    cfg = pose_estimator.make_config(
        pose_estimator.build_parser().parse_args(argv))
    ds = Urso()
    ds.load_dataset(os.path.join(root, 'urso'), cfg, 'train')
    gen = loader.data_generator(ds, cfg, batch_size=cfg.BATCH_SIZE, seed=seed)
    t0 = time.perf_counter()
    batches = [next(gen) for _ in range(HOST_LOADER_BATCHES)]
    out['host_loader_ips'] = (HOST_LOADER_BATCHES * cfg.BATCH_SIZE
                              / (time.perf_counter() - t0))
    model = build_model(cfg, dev, torch.Generator().manual_seed(seed))
    step = make_train_step(model, cfg, make_optimizer(cfg), device=dev)
    mb = loader.molded_to_device(batches[0], dev)
    times = []
    for i in range(4):
        t0 = time.perf_counter()
        m = step(mb)
        float(m['loss'])
        times.append(time.perf_counter() - t0)
    out['host_step_ips'] = cfg.BATCH_SIZE / statistics.median(times[1:])
    oh, ow = (int(v) for v in batches[0]['image_meta'][0][1:3])
    log(f"trainbn [host_augment] the host-parity generator alone "
        f"{out['host_loader_ips']:.2f} images/s ({HOST_LOADER_BATCHES} "
        f"batches of {cfg.BATCH_SIZE} from {ow}x{oh} PNGs: decode, camera "
        f"rotation or roll at the "
        f"frame's resolution, resize, mold; one thread) vs the train step "
        f"alone on its batches {out['host_step_ips']:.2f} images/s (host "
        f"wall, median of 3 after 1) vs the epoch "
        f"{out['host_epoch_ips']:.2f} imgs/s {card}")
    del model, step, mb, batches

    # (f) DEBUG_NANS: a NaN in the second batch's images
    cfg = with_train_bn(cfg_fn(False))
    cfg.AUGMENT_ON_DEVICE = False
    cfg.DEBUG_NANS = True
    cfg.IMAGES_PER_GPU = 2
    cfg.STEPS_PER_EPOCH = 2
    cfg.update()
    real, seen = loader._load_parity, []

    def poisoned(*a):
        sample = real(*a)
        seen.append(a[2])
        if len(seen) == cfg.BATCH_SIZE + 1:
            sample['images'][5, 7, 1] = np.nan
        return sample
    loader._load_parity = poisoned
    try:
        eng = UrsoNet('training', cfg, os.path.join(root, 'trainbn_nans'),
                      device=dev)
        eng.train(ds, None, None, epochs=1, log_fn=lambda *a: None)
    except FloatingPointError as e:
        log(f"trainbn [DEBUG_NANS] raised FloatingPointError: "
            f"{str(e)[:160]}")
        if 'train step 1' not in str(e):
            raise RuntimeError(f"DEBUG_NANS named another step: {e}")
    else:
        raise RuntimeError("DEBUG_NANS did not raise on a NaN batch")
    finally:
        loader._load_parity = real
    return out


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# phase 8d: serving under the knobs bench.py reads


KNOB_CALIB = 8        # images each knob's model is calibrated on
KNOB_PLAIN = 8        # images of a served batch held whole against plain
PRUNE_MULTS = (0.5, 0.6)
KNOB_TRAIN_STEPS = 2  # F16 fine-tuning steps of the pruned flagship
# The served configurations of phase 8d beside the default F16 `base`
# and `host_s2d` batches: (tag, stem variant, F16, serving_config knobs,
# shortcut requant sites dropped, bias_correct). bias_correct runs once,
# under QUANT_S8_JOIN, whose capture pass keeps the default joins as the
# JAX package's does.
KNOB_CASES = (
    ('s8_join base', 'base', True, dict(s8_join=True), False, True),
    ('s8_join host_s2d', 'host_s2d', True, dict(s8_join=True), False, False),
    ('s8_join base f32', 'base', False, dict(s8_join=True), False, False),
    ('float residual', 'base', True, {}, True, False),
    ('float residual f32', 'base', False, {}, True, False),
    ('s8_join float residual', 'base', True, dict(s8_join=True), True,
     False),
    ('bf16_stem base', 'base', True, dict(bf16_stem=True), False, False),
    ('bf16_stem s2d', 's2d', True, dict(bf16_stem=True), False, False),
    ('float_cls_final', 'base', True, dict(float_cls_final=True), False,
     False),
    ('float_reg_head', 'base', True, dict(float_reg_head=True), False,
     False))


def knob_serving_config(batch, variant='base', f16=True, inner_mult=1.0,
                        s8_join=False, bf16_stem=False,
                        float_cls_final=False,
                        float_reg_head=False) -> Config:
    """serving_config() under the knobs bench.py reads, and the head
    knobs QUANT_FLOAT_CLS_FINAL / QUANT_FLOAT_REG_HEAD."""
    cfg = presets.serving_config(batch, variant, f16, inner_mult, s8_join,
                                 bf16_stem)
    cfg.QUANT_FLOAT_CLS_FINAL = float_cls_final
    cfg.QUANT_FLOAT_REG_HEAD = float_reg_head
    cfg.update()
    return cfg


def _stem_call(a, dev, rng):
    """Fresh operands for one recorded stem_s8 call: (kernel fn, plain
    fn); the raw batch and the 7x7 chain for an 'nhwc' call."""
    acc = ACC_DTYPES[a['acc']]
    if a['route'] == 'nhwc':
        x, w7, w4 = nhwc_operands(dev, rng, a['b'], 2 * a['h2'], 2 * a['w2'])
        kw = dict(nhwc_args(dev, rng, a['mode']), acc_dtype=acc)
        return (lambda: int8_cuda.stem_s8(x, w4, **kw),
                lambda: int8_cuda.stem_s8_nhwc_torch(x, w7, **kw))
    x, w = stem_operands(dev, rng, a['b'], a['h2'], a['w2'])
    kw = dict(stem_args(dev, rng, a['mode']), acc_dtype=acc)
    return (lambda: int8_cuda.stem_s8(x, w, **kw),
            lambda: int8_cuda.stem_s8_torch(x, w, **kw))


def kernel_row(name, a) -> str:
    """The kernels line's row of a recorded int8 call: the kernel, the
    stem's 'nhwc' route apart, `_f32acc` in the f32-epilogue mode."""
    nhwc = name == 'stem_s8' and a['route'] == 'nhwc'
    return name + ('_nhwc' if nhwc else '') \
        + ('' if a['acc'] == 'bf16' else '_f32acc')


def launch_rows(launches, sfx, names=('gemm_s8', 'conv_s8', 'stem_s8')):
    """Launches by kernels-line row from an `int8_cuda.launches`
    snapshot: the stem's 'nhwc' route under a row of its own."""
    out = Counter({k + sfx: launches[k] for k in names})
    if 'stem_s8' in names:
        out['stem_s8' + sfx] -= launches['stem_s8_nhwc']
        out['stem_s8_nhwc' + sfx] += launches['stem_s8_nhwc']
    return out


def check_new_calls(tag, calls, dev, rng, seen: set) -> Counter:
    """Each distinct gemm_s8 / conv_s8 / stem_s8 call of a served batch
    not in `seen`, on fresh operands of its shapes and residual type,
    against its plain version: any differing element raises. Adds them
    to `seen`; returns the checked calls by (kernel row, epilogue,
    residual)."""
    done = Counter()
    for name, items in sorted({(n, tuple(sorted(a.items())))
                               for n, a in calls} - seen):
        a = dict(items)
        if name == 'stem_s8':
            fn, plain = _stem_call(a, dev, rng)
        else:
            fn, plain, *_ = _int8_call(name, a, dev, rng)
        _must_equal(f"knobs [{tag}] {name} "
                    f"[{' '.join(f'{k}={v}' for k, v in items)}]",
                    fn(), plain())
        del fn, plain
        seen.add((name, items))
        done[kernel_row(name, a), a.get('epilogue', 'q8_relu'),
             a.get('res', '-')] += 1
    return done


def _aligned_route(name, a) -> str:
    """The route a served call must take, from its shapes alone: TMA
    where K (C for a conv) and N are multiples of 16, else the mma.sync
    one; for the fused stem `stem_route`'s (its 'nhwc' route on the raw
    batch)."""
    if name == 'stem_s8':
        if a['c'] == 3:
            return int8_cuda.stem_route(2 * a['w2'], True, 3, 2 * a['h2'])
        return int8_cuda.stem_route(a['w2'])
    k = a['k'] if name == 'gemm_s8' else a['c']
    return 'tma' if k % 16 == 0 and a['n'] % 16 == 0 else 'ragged'


def serve_knob(engine, tag, images, dev, rng, seen, drop_sc=False,
               bias_correct=False, iters=SERVE_ITERS) -> dict:
    """One configuration of phase 8d: quantize the engine's float model,
    calibrate on KNOB_CALIB images and smooth(0.5) (and bias_correct
    under `bias_correct`); `drop_sc` removes the shortcut requant sites
    from the scales, as an artifact calibrated before they existed. Then
    one served batch through predict_molded: finite heads of their
    shapes, every call on the route its shapes give it, the calls not
    seen before on fresh operands and KNOB_PLAIN images served whole
    equal to the plain version, within the random-init gate of the float
    twin; on the card the batch's median time."""
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = engine.config
    qm = engine.quantize()
    xc = engine._host_s2d_maybe(images[:KNOB_CALIB])
    qm.calibrate(xc)
    qm.smooth(0.5)
    if drop_sc:
        qm.act_scales = {k: v for k, v in qm.act_scales.items()
                         if not k.endswith(('branch1/out', 'sc/out'))}
    if bias_correct:
        deltas = qm.bias_correct(xc, passes=1)
        if not all(np.isfinite(v).all() for v in qm.bias_delta.values()):
            raise RuntimeError(f"knobs [{tag}]: non-finite bias deltas")
        log(f"knobs [{tag}] bias_correct(passes=1): {len(deltas)} sites, "
            f"largest |delta| {max(deltas.values()):.4f}")
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    out = engine.predict_molded(images)
    sync()
    launches, calls = dict(int8_cuda.launches), int8_cuda.calls
    joins = dict(int8_cuda.join_launches)
    int8_cuda.calls = None
    b = len(images)
    for k, v in out.items():
        if v.shape[0] != b or not torch.isfinite(v).all():
            raise RuntimeError(f"knobs [{tag}] {k}: {tuple(v.shape)}, finite "
                               f"{bool(torch.isfinite(v).all())}")
    # the kernels count and record their launches (on the CPU the
    # wrappers run the plain versions, uncounted)
    routes = Counter((n, a['route']) for n, a in calls)
    wrong = [(n, a) for n, a in calls if a['route'] != _aligned_route(n, a)
             and not (n == 'conv_s8' and a['c'] == 3)]
    if wrong:
        raise RuntimeError(f"knobs [{tag}]: calls off their route {wrong[:3]}")
    modes = {a['acc'] for _, a in calls}
    if cuda and modes != {'bf16' if cfg.F16 else 'f32'}:
        raise RuntimeError(f"knobs [{tag}]: launches in modes {modes}")
    checked = check_new_calls(tag, calls, dev, rng, seen)
    x = engine.served_batch(images[:KNOB_PLAIN])
    got, plain = qm(x), qm(x, plain=True)
    sync()
    for k in got:
        if not torch.equal(got[k], plain[k]):
            diff = int((got[k] != plain[k]).sum())
            raise RuntimeError(f"knobs [{tag}] {k}: {diff} values differ "
                               "from the plain version")
    flt = qm.float_twin(xc)
    rels = {k: rel(out[k][:KNOB_CALIB], flt[k]) for k in flt}
    if max(rels.values()) >= quant.RANDOM_INIT_GATE_REL:
        raise RuntimeError(f"knobs [{tag}]: int8 vs float twin {rels} over "
                           "the random-init gate")
    res = {'launches': launches, 'joins': joins, 'routes': routes,
           'checked': checked, 'calls': calls, 'rels': rels}
    if cuda:
        res['ms'] = time_serving(engine, images, dev, iters,
                                 host=False)['median_ms']
    log(f"knobs [{tag}] launches {launches}, joins "
        f"{ {'/'.join(k): v for k, v in joins.items()} }, routes "
        + ", ".join(f"{n} {r} x{c}" for (n, r), c in sorted(routes.items()))
        + f"; {sum(checked.values())} new distinct calls and "
        f"{len(got['loc'])} images served whole equal to the plain version; "
        f"vs float twin "
        + ", ".join(f"{k} {v:.4f}" for k, v in rels.items())
        + (f"; median {res['ms']:.3f} ms a batch of {b}" if cuda else ""))
    return res


def prune_weights(model, root, mult) -> str:
    """`model`'s weights through `python -m ursonet_torch.prune_inner`
    at `mult`; returns the pruned weights file."""
    src = os.path.join(root, 'flagship_weights.msgpack')
    if not os.path.exists(src):
        store.save_weights_file(src, model.state_dict())
    dst = os.path.join(root, f'pruned_{mult}.msgpack')
    run = subprocess.run([sys.executable, '-m', 'ursonet_torch.prune_inner',
                          src, dst, '--mult', str(mult)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise RuntimeError(f"prune_inner --mult {mult}: {run.stderr}")
    for line in run.stdout.strip().splitlines():
        log(f"knobs [prune {mult}] {line}")
    return dst


def run_knobs(root, device, seed: int = 0, card: str = '',
              batch: int = 128, cfg_fn=knob_serving_config,
              cfg2_fn=config2, train_cfg_fn=flagship_config,
              iters: int = SERVE_ITERS) -> dict:
    """Phase 8d. The flagship served under each knob of KNOB_CASES at
    `batch` (`cfg_fn(batch, variant, f16, **knobs)`), its default F16
    `base` and `host_s2d` batches beside them, on one seeded float
    model; config 2 (`cfg2_fn`, batch 1) under QUANT_S8_JOIN and the
    head knobs; the flagship pruned by `python -m
    ursonet_torch.prune_inner` to each of PRUNE_MULTS and served (at 0.6
    the 40- and 152-wide convs take the mma.sync route); two F16 train
    steps of the flagship recipe (`train_cfg_fn(True)`) at
    INNER_WIDTH_MULT=0.5 from the pruned weights, through warp_mold.
    Returns the launches by kernel row, the joins, the batch times."""
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    rng = np.random.RandomState(seed)
    seen: set = set()
    out = {'rows': Counter(), 'joins': Counter(), 'checked': Counter(),
           'ms': {}, 'fused_err': 0.0}

    def add(tag, res, f16=True):
        sfx = '' if f16 else '_f32acc'
        out['rows'].update(launch_rows(res['launches'], sfx))
        out['rows'][C2_REQUANT + sfx] += sum(
            1 for n, a in res['calls']
            if n == 'gemm_s8' and a['epilogue'] == 'q8_relu')
        for (k, ep, r), n in res['joins'].items():
            out['joins'][k + sfx, ep, r] += n
        out['checked'].update(res['checked'])
        if 'ms' in res:
            out['ms'][tag] = res['ms']

    cfg0 = cfg_fn(batch)
    h, w = int(cfg0.IMAGE_SHAPE[0]), int(cfg0.IMAGE_SHAPE[1])
    images = rng.randint(0, 256, (batch, h, w, 3), np.uint8)
    model = ServingEngine(cfg0, dev, generator=torch.Generator()
                          .manual_seed(seed)).model
    for variant in ('base', 'host_s2d'):
        engine = ServingEngine(cfg_fn(batch, variant), dev, model=model)
        add(f'default {variant}', serve_knob(engine, f'default {variant}',
                                              images, dev, rng, seen,
                                              iters=iters))
    for tag, variant, f16, knobs, drop_sc, bc in KNOB_CASES:
        engine = ServingEngine(cfg_fn(batch, variant, f16, **knobs), dev,
                               model=model)
        add(tag, serve_knob(engine, tag, images, dev, rng, seen, drop_sc,
                            bc, iters), f16)
        del engine
    if cuda:
        torch.cuda.empty_cache()

    # config 2 (ResNet-18, batch 1): the basic blocks' joins on conv_s8
    for tag, knob in (('config2 s8_join', 'QUANT_S8_JOIN'),
                      ('config2 float_reg_head', 'QUANT_FLOAT_REG_HEAD'),
                      ('config2 float_cls_final', 'QUANT_FLOAT_CLS_FINAL')):
        cfg2 = cfg2_fn()
        setattr(cfg2, knob, True)
        cfg2.update()
        x2 = rng.randint(0, 256, (max(KNOB_CALIB, cfg2.BATCH_SIZE),
                                  int(cfg2.IMAGE_SHAPE[0]),
                                  int(cfg2.IMAGE_SHAPE[1]), 3), np.uint8)
        engine = ServingEngine(cfg2, dev, generator=torch.Generator()
                               .manual_seed(seed))
        res = serve_knob(engine, tag, x2[:cfg2.BATCH_SIZE], dev, rng, seen,
                         iters=iters)
        add(tag, res, cfg2.F16)
        if cuda and knob == 'QUANT_S8_JOIN' and not any(
                k[:2] == ('conv_s8', 'join_s8') for k in res['joins']):
            raise RuntimeError(f"knobs [{tag}]: conv_s8 ran no join_s8: "
                               f"{res['joins']}")

    # the pruned flagship, served and fine-tuned
    pruned = {}
    for mult in PRUNE_MULTS:
        pruned[mult] = prune_weights(model, root, mult)
        cfg = cfg_fn(batch, inner_mult=mult)
        pmodel = build_model(cfg, dev)
        pmodel.load_state_dict(
            {k: v.to(dev) for k, v in
             store.load_weights_file(pruned[mult]).items()})
        engine = ServingEngine(cfg, dev, model=pmodel)
        res = serve_knob(engine, f'pruned {mult}', images, dev, rng, seen,
                         iters=iters)
        add(f'pruned {mult}', res)
        # the mma.sync route, but for the C = 3 stem conv of `base`
        ragged = sum(1 for n, a in res['calls'] if a['route'] == 'ragged'
                     and not (n == 'conv_s8' and a['c'] == 3))
        if cuda and (ragged > 0) != (mult == 0.6):
            raise RuntimeError(f"knobs [pruned {mult}]: {ragged} ragged "
                               "launches")
        del engine, pmodel
        if cuda:
            torch.cuda.empty_cache()
    cfg_t = train_cfg_fn(True)
    cfg_t.INNER_WIDTH_MULT = 0.5
    cfg_t.update()
    tmodel = build_model(cfg_t, dev)
    tmodel.load_state_dict({k: v.to(dev) for k, v in
                            store.load_weights_file(pruned[0.5]).items()})
    warp_cuda.reset_counts()
    with _FusedWarps() as fused:
        res = run_main_path(cfg_t, dev, seed, KNOB_TRAIN_STEPS, model=tmodel)
    losses = [m['loss'] for m in res['train']] + [res['val']['loss']]
    out['warp_mold'] = warp_cuda.launches['warp_mold']
    if not np.isfinite(losses).all() or (cuda and out['warp_mold'] < 1):
        raise RuntimeError(f"knobs [pruned 0.5 train]: losses {losses}, "
                           f"warp_mold x{out['warp_mold']}")
    if cuda:
        out['fused_err'] = check_fused_call('knobs [pruned 0.5 train]',
                                            fused.first)
    log(f"knobs [pruned 0.5 train] F16 batch {cfg_t.BATCH_SIZE}: losses "
        + " ".join(f"{v:.6f}" for v in losses[:-1])
        + f", validation {losses[-1]:.6f}; warp_mold x{out['warp_mold']}")
    del res, tmodel, fused
    if cuda:
        torch.cuda.empty_cache()
        base = out['ms']['default base']
        for tag, ms in out['ms'].items():
            if not tag.startswith('config2'):   # batch 1, another model
                log(f"knobs [{tag}] served batch median {ms:.3f} ms vs the "
                    f"default F16 base {base:.3f} ms ({ms / base - 1:+.1%}) "
                    f"in this run {card}")
    log(f"knobs: joins launched by (kernel, epilogue, residual) "
        f"{ {'/'.join(k): v for k, v in sorted(out['joins'].items())} }; "
        f"calls checked on fresh operands "
        f"{ {'/'.join(k): v for k, v in sorted(out['checked'].items())} }")
    return out


# --------------------------------------------------------------------------
# phase 8e: the Orbax checkpoint store

ORBAX_STEPS = 2      # train steps of each epoch under CHECKPOINT_FORMAT='orbax'
ORBAX_CALIB = 8      # training frames the reloaded weights are quantized on
ORBAX_DECODE_REPS = 3    # passes of the decoder timing over the fixture
ORBAX_FIXTURE = os.path.join(ROOT, 'tests', 'data', 'orbax_fixture.orbax')


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def decoder_mb_s(path, reps: int = 1) -> tuple:
    """(MB/s, decoded bytes) of `checkpoint/zstd.py::decompress` over
    every chunk of the Orbax directory `path` (the frames as the
    directory holds them: compressed by the JAX package's writer, raw
    blocks by the port's), host wall over `reps` passes."""
    from ursonet_torch.checkpoint import ocdbt, zstd
    db = ocdbt.Database(path)
    frames = [db.get(k) for k in db.keys() if not k.endswith('/.zarray')]
    t0 = time.perf_counter()
    n = 0
    for _ in range(reps):
        for f in frames:
            n += len(zstd.decompress(f))
    return n / (time.perf_counter() - t0) / 1e6, n // reps


def fixture_tree() -> dict:
    """The seeded arrays of the committed JAX-written fixture
    (tests/make_orbax_fixture.py, numpy alone)."""
    spec = importlib.util.spec_from_file_location(
        'make_orbax_fixture', os.path.join(ROOT, 'tests',
                                           'make_orbax_fixture.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fixture_tree()


def _same_arrays(tag, got, want, path='') -> int:
    """Nested numpy dicts equal in dtype, shape and bytes; the leaves."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise RuntimeError(f"{tag}: {path or 'the tree'} holds "
                               f"{sorted(got) if isinstance(got, dict) else got}")
        return sum(_same_arrays(tag, got[k], want[k], f'{path}/{k}')
                   for k in want)
    if (got.dtype, got.shape) != (want.dtype, want.shape) \
            or got.tobytes() != want.tobytes():
        raise RuntimeError(f"{tag}: {path} differs")
    return 1


def run_orbax(root, device, seed: int = 0, card: str = '',
              cfg_fn=flagship_config, calib: int = ORBAX_CALIB) -> dict:
    """Phase 8e on the URSO frames under `root/urso`: (a) `cfg_fn()`
    (benchmark_config(3) at full width, batch 32, rotation on) trained
    one epoch of ORBAX_STEPS steps under CHECKPOINT_FORMAT='orbax'
    (warp_mold launched); the state's write and read seconds and bytes;
    (b) a fresh engine's resume_state of the run bit for bit (params,
    batch_stats, velocity, step, epoch), then one more epoch on it and on
    the engine that never stopped: the two equal bit for bit (cuDNN held
    to deterministic algorithms for the phase); (c) the second epoch's
    snapshot loaded by an inference engine, quantized on `calib` frames
    and a batch served: gemm_s8 and conv_s8 on their TMA routes, each
    distinct call and the heads equal to the plain version bit for bit;
    (d) the committed JAX-written fixture read to its seeded arrays, the
    decoder's MB/s on it and on the state. Returns the launches by
    kernel row and the numbers."""
    from ursonet_torch.checkpoint import orbax_store
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {'rows': Counter(), 'fused_err': 0.0}
    t0 = time.perf_counter()
    lib, _ = cuda_build.build('zstd')
    log(f"orbax: zstd decoder {lib.name} ready in "
        f"{time.perf_counter() - t0:.1f} s (g++ at first use)")
    cfg = cfg_fn()
    cfg.CHECKPOINT_FORMAT = 'orbax'
    cfg.STEPS_PER_EPOCH = ORBAX_STEPS
    cfg.update()
    ds = Urso()
    ds.load_dataset(os.path.join(root, 'urso'), cfg, 'train')
    model_dir = os.path.join(root, 'orbax_logs')
    quiet = dict(log_fn=lambda *a: None)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # (a) one epoch under Orbax
        eng = UrsoNet('training', cfg, model_dir, device=dev)
        eng.initialize(seed)
        warp_cuda.reset_counts()
        with _FusedWarps() as fused:
            eng.train(ds, None, cfg.LEARNING_RATE, 1, **quiet)
        sync()
        out['fused_err'] = check_fused_call('orbax (a)', fused.first, cuda)
        del fused
        state = os.path.join(eng.log_dir, 'state_latest.orbax')
        snaps = sorted(f for f in os.listdir(eng.log_dir)
                       if f.startswith('weights_'))
        template = eng.checkpoint_path
        first = store.checkpoint_epoch(template, 0)
        if snaps != [os.path.basename(first)] or not os.path.isdir(state):
            raise RuntimeError(f"orbax (a): run dir holds "
                               f"{sorted(os.listdir(eng.log_dir))}")
        t0 = time.perf_counter()
        store.save_state(state, eng.model, eng.tx, eng.slots, eng.step,
                         eng.epoch)
        out['write_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.load_state(state)
        out['read_s'] = time.perf_counter() - t0
        out['state_bytes'] = _dir_bytes(state)
        out['weights_bytes'] = _dir_bytes(os.path.join(eng.log_dir, snaps[0]))
        log(f"orbax (a) {cfg.BACKBONE} batch {cfg.BATCH_SIZE} "
            f"{cfg.IMAGE_SHAPE[1]}x{cfg.IMAGE_SHAPE[0]}: 1 epoch of "
            f"{ORBAX_STEPS} steps, warp_mold x{warp_cuda.launches['warp_mold']}"
            f"; state_latest.orbax {out['state_bytes']} bytes, written in "
            f"{out['write_s']:.3f} s, read in {out['read_s']:.3f} s (host "
            f"wall); weights snapshot {out['weights_bytes']} bytes {card}")

        # (b) resume bit for bit, then one more epoch on both engines
        eng2 = UrsoNet('training', cfg, model_dir, device=dev)
        if not eng2.resume_state(eng.log_dir):
            raise RuntimeError("orbax (b): no state_latest to resume")
        _same_tensors('orbax (b) params and batch_stats',
                      eng2.model.state_dict(), eng.model.state_dict())
        _same_tensors('orbax (b) velocity', eng2.velocity, eng.velocity)
        if (eng2.step, eng2.epoch) != (eng.step, eng.epoch) \
                or (eng.step, eng.epoch) != (ORBAX_STEPS, 1):
            raise RuntimeError(f"orbax (b): step/epoch {eng2.step}/"
                               f"{eng2.epoch} vs {eng.step}/{eng.epoch}")
        eng.train(ds, None, cfg.LEARNING_RATE, 2, **quiet)
        eng2.train(ds, None, cfg.LEARNING_RATE, 2, **quiet)
        sync()
        _same_tensors('orbax (b) next epoch params and batch_stats',
                      eng2.model.state_dict(), eng.model.state_dict())
        _same_tensors('orbax (b) next epoch velocity', eng2.velocity,
                      eng.velocity)
        log(f"orbax (b) resumed {os.path.basename(eng.log_dir)}: params, "
            f"batch_stats and velocity bit for bit at step {ORBAX_STEPS}; "
            f"the next epoch ({ORBAX_STEPS} steps) on the resumed engine "
            f"equals the uninterrupted one's bit for bit (step {eng2.step})")
        for k in ('warp_homography', 'warp_mold'):
            out['rows'][k] += warp_cuda.launches[k]
        if cuda and warp_cuda.launches['warp_mold'] < 1:
            raise RuntimeError("orbax: the train path never launched "
                               "warp_mold")
        want = eng.model.state_dict()
        del eng2
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # (c) the snapshot served int8
    inf = UrsoNet('inference', cfg, model_dir, device=dev)
    snap = inf.find_last()
    if snap != store.checkpoint_epoch(template, 1):
        raise RuntimeError(f"orbax (c): find_last gave {snap}")
    t0 = time.perf_counter()
    inf.load_weights(snap)
    out['load_weights_s'] = time.perf_counter() - t0
    _same_tensors('orbax (c) loaded weights', inf.model.state_dict(), want)
    del eng, want
    images = [ds.load_image(i) for i in range(cfg.BATCH_SIZE)]
    qm = inf.quantize(images[:calib])
    molded = inf.mold_inputs(images)[0]
    int8_cuda.reset_counts()
    int8_cuda.calls = []
    served = inf.serving.predict_molded(molded)
    sync()
    launches, calls = dict(int8_cuda.launches), int8_cuda.calls
    int8_cuda.calls = None
    log(f"orbax (c) {os.path.basename(snap)} loaded in "
        f"{out['load_weights_s']:.3f} s (host wall), quantized on {calib} "
        f"frames, served batch of {len(images)}: launches {launches}")
    if cuda:
        if min(launches['gemm_s8'], launches['conv_s8']) < 1:
            raise RuntimeError(f"orbax (c): launches {launches}")
        check_served_routes('orbax', calls)
        check_served_calls('orbax', calls, dev, np.random.RandomState(seed))
    sfx = '' if ACC_NAMES[qm.acc_dtype] == 'bf16' else '_f32acc'
    out['rows'].update(launch_rows(launches, sfx))
    out['rows'][C2_REQUANT + sfx] += sum(
        1 for n, a in calls if n == 'gemm_s8' and a.get('epilogue') ==
        'q8_relu')
    plain = qm(inf.serving.served_batch(molded), plain=True)
    for k, v in served.items():
        diff = int((v != plain[k]).sum())
        if diff or not torch.isfinite(v).all():
            raise RuntimeError(f"orbax (c) {k}: {diff} values differ from "
                               "the plain version")
    log("orbax (c) the served heads equal the plain version's (0 differing "
        "values)")
    del inf, qm, served, plain
    if cuda:
        torch.cuda.empty_cache()

    # (d) the JAX-written fixture, and the decoder's rate
    t0 = time.perf_counter()
    got = orbax_store.load_weights_dir(ORBAX_FIXTURE)
    fx_s = time.perf_counter() - t0
    want = fixture_tree()
    n = _same_arrays('orbax (d) fixture', got['params'], want['params'])
    if got['batch_stats'] is not None:
        raise RuntimeError("orbax (d): the fixture's empty batch_stats "
                           f"read as {got['batch_stats']}")
    out['fixture_mb_s'], fx_bytes = decoder_mb_s(ORBAX_FIXTURE,
                                                 ORBAX_DECODE_REPS)
    out['state_mb_s'], st_bytes = decoder_mb_s(state)
    log(f"orbax (d) the JAX package's fixture ({_dir_bytes(ORBAX_FIXTURE)} "
        f"bytes, zstd level 1) read in {fx_s:.3f} s: its {n} arrays equal "
        f"the seeded ones bit for bit")
    log(f"orbax (d) zstd decoder (host): {out['fixture_mb_s']:.1f} MB/s on "
        f"the fixture's frames ({fx_bytes} bytes decoded, Huffman and FSE), "
        f"{out['state_mb_s']:.1f} MB/s on the state's ({st_bytes} bytes, "
        f"raw blocks) {card}")
    return out


# --------------------------------------------------------------------------
# phase 8f: parallelism over torch.distributed ranks

PAR_MESH = (2, 2)     # the (data, model) world of four ranks on one card
PAR_BATCH = 16        # its global batch: 8 images a data row
PAR_STEPS = 2         # train steps of each parallel run
PAR_SERVE = 128       # int8 images served under the world of one's mesh
PAR_CALIB = 8         # images the int8 models are calibrated on
PAR_REL = dict(rtol=2e-4, atol=2e-5)   # tests/test_parallel.py's bounds


def par_config(cfg, per_row: int, mesh=(1, 1)) -> Config:
    """`cfg` at `per_row` images a data row over a (data, model) mesh."""
    cfg = copy.deepcopy(cfg)
    cfg.IMAGES_PER_GPU = per_row
    cfg.MESH_DATA, cfg.MESH_MODEL = mesh
    cfg.update()
    return cfg


def state_digest(tensors: dict) -> str:
    """sha256 over the bytes of `tensors` in name order."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class _Buckets:
    """While open, counts the train step's bucketed gradient
    all-reduces (`parallel/sharding.py::all_reduce_bucket`)."""

    def __enter__(self):
        from ursonet_torch.train import step as step_mod
        self.mod, self.n = step_mod, 0
        self.saved = step_mod.all_reduce_bucket

        def counted(tensors, group):
            self.n += 1
            return self.saved(tensors, group)
        step_mod.all_reduce_bucket = counted
        return self

    def __exit__(self, *exc):
        self.mod.all_reduce_bucket = self.saved


def _par_steps(cfg, dev, seed, raw, mesh=None, model=None, tx=None):
    """PAR_STEPS train steps with warp_mold on `raw` (this rank's rows
    under a mesh); each step draws the global batch's augmentation from
    its own seed. Returns (losses, model, step fn, first warp_mold call,
    bucketed all-reduces)."""
    from ursonet_torch.parallel.sharding import shard_model
    if model is None:
        model = build_model(cfg, dev, torch.Generator().manual_seed(seed))
        if mesh is not None:
            shard_model(model, mesh, cfg)
    pre = make_device_preprocess(cfg, device=dev)
    step = make_train_step(model, cfg, tx or make_optimizer(cfg),
                           trainable_mask(model, 'all'), pre, dev, mesh)
    losses = []
    with _FusedWarps() as fused, _Buckets() as buckets:
        for i in range(PAR_STEPS):
            m = step(raw, torch.Generator().manual_seed(seed + 1 + i))
            losses.append(float(m['loss']))
    return losses, model, step, fused.first, buckets.n


def _count_int8(calls, rows, sfx='_f32acc') -> None:
    for k in ('gemm_s8', 'conv_s8'):
        rows[k + sfx] += sum(1 for n, _ in calls if n == k)
    for n, a in calls:
        if n == 'stem_s8':
            rows[kernel_row(n, a)] += 1
    rows[C2_REQUANT + sfx] += sum(1 for n, a in calls if n == 'gemm_s8'
                                  and a.get('epilogue') == 'q8_relu')


def world_of_one(dev, cfg, seed, card, train_ms, serve=PAR_SERVE) -> dict:
    """Phase 8f (a): a world of one rank in this process (NCCL on the
    card, gloo on the CPU; a FileStore), its 1 x 1 DeviceMesh: the train
    step through the parallel path (the bucketed all-reduce executed)
    equal to the step without a mesh bit for bit, and int8 serving under
    shard_over of the mesh equal to unsharded serving bit for bit. Also
    the world-of-one reference of part (b): its global batch's steps."""
    import torch.distributed as dist

    from ursonet_torch.parallel import make_mesh, multihost
    cuda = dev.type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rows = Counter()
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as d:
        multihost.initialize(f'file://{d}/store', 1, 0,
                             backend='nccl' if cuda else 'gloo', device=dev)
        try:
            mesh = make_mesh(data=1, model=1)
            if mesh.device_mesh is None:
                raise RuntimeError("parallel: no DeviceMesh in the world "
                                   "of one")
            log(f"parallel [world of one] backend {dist.get_backend()}, "
                f"{mesh}")
            raw = make_raw_batch(cfg, seed)
            got, steps = {}, {}
            for tag, m in (('no mesh', None), ('mesh 1x1', mesh)):
                warp_cuda.reset_counts()
                losses, model, step, first, buckets = _par_steps(
                    cfg, dev, seed, raw, m)
                sync()
                if tag == 'mesh 1x1':
                    rows['warp_homography'] += warp_cuda.launches[
                        'warp_homography']
                    rows['warp_mold'] += warp_cuda.launches['warp_mold']
                    if buckets != PAR_STEPS:
                        raise RuntimeError(f"parallel: {buckets} bucketed "
                                           f"all-reduces in {PAR_STEPS} "
                                           "steps")
                    out['fused_err'] = check_fused_call('parallel [world '
                                                        'of one]', first,
                                                        cuda)
                got[tag] = (losses, {k: v.clone() for k, v in
                                     model.state_dict().items()})
                steps[tag] = step
                del model
            (l0, s0), (l1, s1) = got['no mesh'], got['mesh 1x1']
            diff = [k for k in s0 if not torch.equal(s0[k], s1[k])]
            if l0 != l1 or diff:
                raise RuntimeError(f"parallel [world of one]: losses {l1} "
                                   f"vs {l0}, {len(diff)} tensors differ "
                                   f"({diff[:4]})")
            log(f"parallel [world of one] {PAR_STEPS} steps equal the "
                f"step without a mesh bit for bit: losses {l1}, "
                f"{len(s1)} tensors, {PAR_STEPS} bucketed all-reduces")
            if cuda:
                # both steps timed in turns under the run's cuDNN setting
                # (the comparison above held it deterministic)
                torch.backends.cudnn.deterministic = deterministic
                ms = {tag: [] for tag in steps}
                for tag in ('no mesh', 'mesh 1x1', 'mesh 1x1', 'no mesh'):
                    ms[tag].append(time_train({'step': steps[tag],
                                               'raw': raw}, seed))
                out['step_ms'] = {k: statistics.mean(v)
                                  for k, v in ms.items()}
                torch.backends.cudnn.deterministic = True
                t = out['step_ms']
                log(f"parallel [world of one] train step (mean of two "
                    f"medians of 10, in turns): {t['mesh 1x1']:.3f} ms "
                    f"through the mesh vs {t['no mesh']:.3f} ms without it "
                    f"({ms}); phase 4's {train_ms:.3f} ms; batch "
                    f"{cfg.BATCH_SIZE} {card}")
            del steps
            # int8 serving under shard_over(mesh) against unsharded
            model = build_model(cfg, dev, torch.Generator().manual_seed(
                seed))
            model.load_state_dict(s1)
            engine = ServingEngine(cfg, dev, model=model, mesh=mesh)
            rng = np.random.RandomState(seed)
            h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
            images = rng.randint(0, 256, (serve, h, w, 3), np.uint8)
            qm = engine.quantize()
            qm.calibrate(images[:PAR_CALIB])
            int8_cuda.reset_counts()
            int8_cuda.calls = []
            served = engine.predict_molded(images)
            sync()
            launches = dict(int8_cuda.launches)
            calls, int8_cuda.calls = int8_cuda.calls, None
            _count_int8(calls, rows)
            if qm.mesh is not None:
                raise RuntimeError("shard_over of a 1 x 1 mesh sharded")
            alone = qm.shard_over(None)(images)
            for k in alone:
                if not torch.equal(served[k], alone[k]):
                    raise RuntimeError(f"parallel [world of one] serve {k}:"
                                       " differs from unsharded serving")
            plain = qm(images[:PAR_CALIB], plain=True)
            for k in plain:
                if not torch.equal(served[k][:PAR_CALIB], plain[k]):
                    raise RuntimeError(f"parallel [world of one] serve {k}:"
                                       " differs from the plain version")
            log(f"parallel [world of one] int8 batch {serve} under "
                f"shard_over(mesh) equals unsharded serving bit for bit, "
                f"{PAR_CALIB} images equal the plain version; launches "
                f"{launches}")
            del engine, qm, model, served, alone
            # the reference of part (b): the global batch at one rank,
            # convolutions in full f32 as the world runs them
            ref_cfg = par_config(cfg, PAR_BATCH)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                losses, model, _, _, _ = _par_steps(
                    ref_cfg, dev, seed, make_raw_batch(ref_cfg, seed), mesh)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            out['ref'] = (losses, {k: v.cpu() for k, v in
                                   model.state_dict().items()})
            del model
        finally:
            multihost.shutdown()
            torch.backends.cudnn.deterministic = deterministic
    out['rows'] = rows
    return out


def parallel_rank(rank: int, d: str, resume: bool = False) -> None:
    """One rank of phase 8f (b), run as its own process (`python -c
    "import chip_smoke; chip_smoke.parallel_rank(...)"`): joins the 2 x 2
    gloo world of `d/spec.json` on its device (all ranks on one card,
    asked for explicitly); trains PAR_STEPS steps on its rows of the
    global batch through UrsoNet's model, writes the state through rank
    0, serves int8 over the 2 data rows; or, with `resume`, resumes that
    state in a fresh world. Writes `d/rank<r>[_resume].json`."""
    from ursonet_torch.parallel import multihost
    from ursonet_torch.parallel.sharding import gathered, model_split
    # full f32 convolutions: under TF32 a parameter that differs from the
    # world of one's by rounding may round to another TF32 value, and the
    # second step's loss moved by 1.5e-4 relative on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    spec = json.load(open(os.path.join(d, 'spec.json')))
    dev = torch.device(spec['device'])
    cuda = dev.type == 'cuda'
    if not cuda:
        torch.set_num_threads(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    seed = spec['seed']
    cfg = Config.from_dict(spec['config'])
    store_dir = os.path.join(d, 'world_resume' if resume else 'world')
    os.makedirs(store_dir, exist_ok=True)
    multihost.initialize(f"file://{store_dir}/store", 4, rank,
                         backend='gloo', device=dev)
    t0 = time.perf_counter()
    res = {'rank': rank}
    try:
        eng = UrsoNet('training', cfg, os.path.join(d, 'logs'), device=dev)
        mesh = eng.mesh
        if resume:
            if not eng.resume_state(spec['run_dir']):
                raise RuntimeError("no state to resume")
            res['digest'] = state_digest({**eng.model.state_dict(), **{
                f'{s}/{n}': v for s, vs in eng.slots.items()
                for n, v in vs.items()}})
            res['shapes'] = {k: list(v.shape) for k, v in
                             eng.model.state_dict().items()
                             if k in model_split(eng.model)}
            return
        model = eng.initialize(seed)
        eng._bind_slots([n for n, _ in model.named_parameters()])
        lo, hi = multihost.local_batch_slice(mesh, cfg.BATCH_SIZE)
        raw = {k: v[lo:hi] for k, v in make_raw_batch(cfg, seed).items()}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        warp_cuda.reset_counts()
        t1 = time.perf_counter()
        losses, _, step, first, buckets = _par_steps(
            cfg, dev, seed, raw, mesh, model, eng.tx)
        sync()
        res['steps_s'] = time.perf_counter() - t1
        res['warp'] = dict(warp_cuda.launches)
        res['fused_err'] = check_fused_call(f'parallel rank {rank}', first,
                                            cuda)
        res['losses'], res['buckets'] = losses, buckets
        res['shard_shapes'] = {k: list(v.shape) for k, v in
                               model.state_dict().items()
                               if k in model_split(model)}
        eng.step = PAR_STEPS
        whole = gathered(model, mesh).state_dict()
        if mesh.is_writer:
            torch.save(whole, os.path.join(d, 'whole.pt'))
        slots = {s: multihost.fetch_global(v, mesh, model_split(model))
                 for s, v in eng.slots.items()}
        res['whole_digest'] = state_digest({**whole, **{
            f'{s}/{n}': v for s, vs in slots.items()
            for n, v in vs.items()}})
        t1 = time.perf_counter()
        eng.save_state(1)
        res['save_s'] = time.perf_counter() - t1
        res['run_dir'] = eng.log_dir
        res['digest'] = state_digest({**model.state_dict(), **{
            f'{s}/{n}': v for s, vs in eng.slots.items()
            for n, v in vs.items()}})
        # int8 serving over the 2 data rows
        rng = np.random.RandomState(seed)
        h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
        images = rng.randint(0, 256, (PAR_BATCH, h, w, 3), np.uint8)
        qm = eng.quantize()
        qm.calibrate(images[:PAR_CALIB])
        int8_cuda.reset_counts()
        int8_cuda.calls = []
        served = eng.predict_molded(images)
        sync()
        calls, int8_cuda.calls = int8_cuda.calls, None
        rows = Counter()
        _count_int8(calls, rows)
        res['int8'] = dict(rows)
        served = {k: v.cpu() for k, v in served.items()}
        qm.shard_over(None)
        alone = {k: v.cpu() for k, v in qm(images).items()}
        lo, hi = multihost.local_batch_slice(mesh, PAR_BATCH)
        plain = {k: v.cpu() for k, v in qm(images[lo:hi],
                                           plain=True).items()}
        res['serve'] = {}
        for k in alone:
            exact = bool(torch.equal(served[k], alone[k]))
            res['serve'][k] = {
                'exact': exact, 'rel': rel(served[k], alone[k]),
                'plain_equal': bool(torch.equal(served[k][lo:hi],
                                                plain[k]))}
        res['peak'] = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        res['seconds'] = time.perf_counter() - t0
        multihost.shutdown()
        with open(os.path.join(
                d, f"rank{rank}{'_resume' if resume else ''}.json"),
                'w') as f:
            json.dump(res, f)


def _spawn_world(d, resume=False, timeout=600) -> list:
    """The four ranks of phase 8f (b) as processes; their JSON results.
    Every process is waited for (killed if it outlives `timeout`)."""
    cmd = (f"import chip_smoke as c; import sys; "
           f"c.parallel_rank(int(sys.argv[1]), sys.argv[2], {resume})")
    procs = [subprocess.Popen([sys.executable, '-c', cmd, str(r), d],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"parallel rank {bad[0]} failed:\n"
                           f"{outs[bad[0]][-6000:]}")
    tag = '_resume' if resume else ''
    return [json.load(open(os.path.join(d, f'rank{r}{tag}.json')))
            for r in range(4)]


def run_parallel(root, device, seed: int = 0, card: str = '',
                 cfg=None, train_ms: float = float('nan'),
                 serve: int = PAR_SERVE) -> dict:
    """Phase 8f. (a) `world_of_one`. (b) a 2 x 2 world of four processes
    under gloo on the one card (each rank's device given explicitly):
    the flagship recipe at full width (ResNet-50, bottleneck 128,
    BRANCH_SIZE 1024, 24^3 bins so that the 13,824-wide ori_final is
    split by its in features, 512x640, rotation through warp_mold) at a
    global batch of PAR_BATCH, PAR_STEPS steps: loss and every parameter
    against the world of one on the same global batch (PAR_REL), each
    rank's first warp_mold call against the plain chain; rank 0's state
    whole in the JAX layout (its tree equal to the gathered one bit for
    bit) and resumed by a fresh 2 x 2 world bit for bit on every rank;
    int8 served over the 2 data rows: the classified orientation (the
    int8 body) equal to one rank's unsharded serving bit for bit, the
    float location final within 1e-5 relative, each rank's rows equal to
    the plain version. Part (b) and its reference run the convolutions
    in full f32 (TF32 off). `serve`: the world of one's served batch.
    Returns the launches by kernel row."""
    dev = torch.device(device)
    cfg = cfg or flagship_config()
    t0 = time.perf_counter()
    one = world_of_one(dev, cfg, seed, card, train_ms, serve)
    rows = one['rows']
    log(f"parallel [world of one]: {time.perf_counter() - t0:.1f} s")
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    d = os.path.join(root, 'parallel')
    os.makedirs(d)
    wcfg = par_config(cfg, PAR_BATCH // PAR_MESH[0], PAR_MESH)
    with open(os.path.join(d, 'spec.json'), 'w') as f:
        json.dump({'device': str(dev), 'seed': seed,
                   'config': wcfg.to_dict()}, f)
    ranks = _spawn_world(d)
    log(f"parallel [2x2 gloo world]: {time.perf_counter() - t1:.1f} s, "
        f"ranks' own seconds {[round(r['seconds'], 1) for r in ranks]}")
    # the training against the world of one on the same global batch
    ref_losses, ref = one['ref']
    got = torch.load(os.path.join(d, 'whole.pt'))
    worst, worst_name = 0.0, None
    for k, v in ref.items():
        excess = float(((got[k] - v).abs() - PAR_REL['rtol'] * v.abs())
                       .max()) if v.numel() else 0.0
        if excess > worst:
            worst, worst_name = excess, k
    maxdiff = max(float((got[k] - v).abs().max()) for k, v in ref.items()
                  if v.numel())
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(ranks[0]['losses'], ref_losses))
    log(f"parallel [2x2] losses {ranks[0]['losses']} vs world of one "
        f"{ref_losses}: largest relative difference {loss_rel:.3e}; "
        f"parameters: largest abs difference {maxdiff:.3e}, largest "
        f"excess over rtol {PAR_REL['rtol']} {worst:.3e} ({worst_name}; "
        f"atol {PAR_REL['atol']})")
    if loss_rel > 1e-5 or worst > PAR_REL['atol']:
        raise RuntimeError("parallel [2x2]: the world's step differs from "
                           "the world of one")
    if any(r['losses'] != ranks[0]['losses'] for r in ranks):
        raise RuntimeError("parallel [2x2]: the ranks' losses differ")
    n_ori = wcfg.ORI_BINS_PER_DIM ** 3
    for r in ranks:
        sh = r['shard_shapes'].get('ori_head.ori_final.weight')
        if sh != [n_ori, wcfg.BRANCH_SIZE // PAR_MESH[1]]:
            raise RuntimeError(f"parallel rank {r['rank']}: ori_final "
                               f"shard {sh}")
        if r['buckets'] != PAR_STEPS or (
                dev.type == 'cuda' and r['warp']['warp_mold'] < PAR_STEPS):
            raise RuntimeError(f"parallel rank {r['rank']}: buckets "
                               f"{r['buckets']}, warp {r['warp']}")
        rows['warp_homography'] += r['warp']['warp_homography']
        rows['warp_mold'] += r['warp']['warp_mold']
        for k, n in r['int8'].items():
            rows[k] += n
    fused_err = max([one['fused_err']] + [r['fused_err'] for r in ranks])
    # rank 0's file against the gathered tree, then a fresh world resumes
    path = os.path.join(ranks[0]['run_dir'], 'state_latest.msgpack')
    tree = store.load_state(path)
    file_digest = state_digest({**tree['state_dict'], **{
        f'{s}/{n}': v for s, vs in tree['slots'].items()
        for n, v in vs.items()}})
    if file_digest != ranks[0]['whole_digest']:
        raise RuntimeError("parallel [2x2]: rank 0's state file differs "
                           "from the gathered tree")
    with open(os.path.join(d, 'spec.json'), 'w') as f:
        json.dump({'device': str(dev), 'seed': seed, 'run_dir':
                   ranks[0]['run_dir'], 'config': wcfg.to_dict()}, f)
    t2 = time.perf_counter()
    back = _spawn_world(d, resume=True)
    for r, b in zip(ranks, back):
        if b['digest'] != r['digest']:
            raise RuntimeError(f"parallel [2x2] rank {r['rank']}: the "
                               "resumed state differs")
    log(f"parallel [2x2] rank 0 wrote the whole state "
        f"({os.path.getsize(path)} bytes, {ranks[0]['save_s']:.2f} s with "
        f"the gather); its tree equals the gathered one bit for bit, and a "
        f"fresh 2x2 world resumed every rank's shards bit for bit "
        f"({time.perf_counter() - t2:.1f} s)")
    for r in ranks:
        s = r['serve']
        if not (s['ori']['exact'] and s['loc']['rel'] <= 1e-5
                and all(v['plain_equal'] for v in s.values())):
            raise RuntimeError(f"parallel rank {r['rank']} int8 serving: "
                               f"{s}")
    log(f"parallel [2x2] int8 batch {PAR_BATCH} over 2 data rows: ori (int8"
        f" body) equal to one rank's serving bit for bit, loc (float "
        f"final) within {max(r['serve']['loc']['rel'] for r in ranks):.2e}"
        f" relative, each rank's rows equal to the plain version")
    if dev.type == 'cuda':
        log(f"parallel [2x2] {PAR_STEPS} steps in "
            f"{[round(r['steps_s'], 2) for r in ranks]} s by rank (four "
            f"ranks share one card: no scaling meaning); peak memory by "
            f"rank {[r['peak'] for r in ranks]} bytes {card}")
    log(f"parallel launches: {dict(rows)}")
    return {'rows': rows, 'fused_err': fused_err,
            'seconds': time.perf_counter() - t0}


# --------------------------------------------------------------------------
# phase 8g: TRAIN_ACT_Q8, the int8 saved-activation train step

ACTQ_MODES = (False, True, 'wgrad8')
ACTQ_STEPS = 3       # train steps of each mode's path, then 1 validation step
ACTQ_TIMED = 5       # host-paced launches of each distinct kernel call
# modes a REMAT recipe also steps without REMAT (the same model and batch)
ACTQ_NO_REMAT = ('wgrad8', False)


def _randint8(shape, gen, dev):
    return torch.randint(-127, 128, shape, generator=gen,
                         dtype=torch.int8).to(dev)


def actq_operands(name, args, dev, gen):
    """Fresh operands of a recorded quant_s8 / wgrad_s8 call on `dev`, in
    the call's layouts: (kernel fn, plain fn, kernel fn checked against
    the plain one (wgrad_s8: its int32 sums), extras)."""
    if name == 'wgrad_s8':
        n, ci, h, w = args['q']
        geo = (args['kernel_hw'], args['stride'], args['pads'])
        plan = actq_cuda.wgrad_plan(args['q'], args['co'], *geo)
        q = _randint8((n, ci, h, w), gen, dev)
        qg = _randint8((n, args['co'], plan.ho, plan.wo), gen, dev)
        ql, qgt = actq_cuda.to_layout(q, plan), actq_cuda._qgt(qg, plan=plan)
        alpha = torch.full((ci * plan.kh * plan.kw,), 1e-6, device=dev)
        return (lambda: actq_cuda.wgrad_s8(ql, qgt, *geo, alpha, plan=plan),
                lambda: actq_cuda.wgrad_s8_torch(ql, qgt, *geo, plan),
                lambda: actq_cuda.wgrad_s8(ql, qgt, *geo, plan=plan),
                dict(q=q, qg=qg, geo=geo, plan=plan, alpha=alpha))
    mode, shape, dtype = args['mode'], args['shape'], args['dtype']
    plan = args.get('plan')
    if mode == 'dequant':
        t = _randint8(shape, gen, dev)
        scale = (torch.rand(shape[0], generator=gen) + 0.01).to(dev)
        kw = dict(scale=scale, dtype=args['out_dtype'])
    else:
        t = (torch.randn(shape, generator=gen) * 3).to(dtype).to(dev)
        scale = (torch.rand(shape[0], generator=gen) + 0.01).to(dev)
        kw = dict(plan=plan) if mode == 'x' else dict(
            scale=scale, alpha_len=args['alpha_len'], plan=plan)
    return (lambda: actq_cuda.quant_s8(t, mode, **kw),
            lambda: actq_cuda.quant_s8_torch(t, mode, **kw), None,
            dict(t=t, kw=kw))


def actq_bytes(name, args) -> int:
    """Bytes the function must move, whatever the kernel's layouts: each
    input read once, each output written once, plain. wgrad_s8: int8 q
    [N,Ci,H,W] and qg [N,Co,Ho,Wo], alpha [R] read, f32 dw [Co,R]
    written; im2col_s8 (the gather of wgrad_s8's ragged route): q read,
    the patch matrix P [Ci*KH*KW, Kp] written; 'x': x read, int8 q and
    the scale [N] written; 'g': g and the scale [N] read, int8 qg and
    alpha written; 'dequant': q and the scale read, x written."""
    if name in ('wgrad_s8', 'im2col_s8'):
        n, ci, h, w = args['q']
        kh, kw = args['kernel_hw']
        ho, wo = int8_cuda.conv_out_hw(h, w, kh, kw, args['stride'],
                                       args['pads'])
        r = ci * kh * kw
        if name == 'im2col_s8':
            return n * ci * h * w + r * actq_cuda.padded_k(n * ho * wo)
        return n * ci * h * w + n * args['co'] * ho * wo + 4 * r \
            + 4 * args['co'] * r
    numel = int(np.prod(args['shape']))
    n = args['shape'][0]
    if args['mode'] == 'x':
        return numel * args['dtype'].itemsize + numel + 4 * n
    if args['mode'] == 'g':
        return numel * args['dtype'].itemsize + 4 * n + numel \
            + 4 * args['alpha_len']
    return numel + 4 * n + numel * args['out_dtype'].itemsize


def actq_layout_bytes(name, args) -> int:
    """What the kernels' layouts add to `actq_bytes`: q as KW column
    copies with padded rows and qgt with padded K (`actq_cuda.wgrad_plan`),
    the bytes 'x' writes and wgrad_s8 reads beyond plain q, and 'g'
    writes and wgrad_s8 reads beyond dense qg. Not part of the bound."""
    if name == 'wgrad_s8':
        plan = actq_cuda.wgrad_plan(args['q'], args['co'], args['kernel_hw'],
                                    args['stride'], args['pads'])
    else:
        plan = args.get('plan')
    if plan is None or args.get('mode') == 'dequant':
        return 0
    extra_q = int(np.prod(plan.q_shape)) - plan.n * plan.ci * plan.h * plan.w
    extra_qg = plan.co * plan.kp - plan.n * plan.co * plan.ho * plan.wo
    if name == 'wgrad_s8':
        return extra_q + extra_qg
    return extra_q if args['mode'] == 'x' else extra_qg


def actq_ops(name, args) -> int:
    """Operations of a wgrad_s8 call: 2 M N K over the valid columns."""
    if name != 'wgrad_s8':
        return 0
    n, ci, h, w = args['q']
    kh, kw = args['kernel_hw']
    ho, wo = int8_cuda.conv_out_hw(h, w, kh, kw, args['stride'],
                                   args['pads'])
    return 2 * args['co'] * ci * kh * kw * n * ho * wo


def _call_key(name, args):
    return (name,) + tuple(sorted((k, str(v)) for k, v in args.items()))


def _must_equal_all(name, args, got, want, what=''):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise RuntimeError(f"{name} {what}{args}: the kernel differs from "
                               "its plain version")


def _actq_world(dev):
    """A gloo world of one process (a file store in a temp dir), for
    quant_s8 'g' under a data-parallel group: its two launches and the
    all-reduce between them. Returns (group, cleanup)."""
    import torch.distributed as dist

    from ursonet_torch.parallel import multihost
    if dist.is_initialized():
        return dist.group.WORLD, lambda: None
    d = tempfile.mkdtemp()
    multihost.initialize(f'file://{d}/store', 1, 0, backend='gloo',
                         device=dev)

    def cleanup():
        multihost.shutdown()
        shutil.rmtree(d, ignore_errors=True)
    return dist.group.WORLD, cleanup


def check_actq_calls(calls, dev, seed, timed: bool) -> dict:
    """Each distinct quant_s8 / wgrad_s8 call of a step (`calls`, one
    step's) on fresh operands, against its plain version (0 differing
    values: the quantizes bit for bit, wgrad_s8's int32 sums and its f32
    epilogue): wgrad_s8 on its own route and on the ragged one, quant_s8
    'g' also under a data-parallel group (a gloo world of one: its two
    launches). With `timed`: the device time by CUDA graph (`graph_ms`),
    the host pace (back-to-back calls between events), the plain
    version's time and, for wgrad_s8, torch._int_mm's on its patch matrix
    (graph) and the ragged route's; each weighted by the call's count in
    the step. The gather of each ragged wgrad_s8 call (im2col_s8, the
    path's own launch of it) apart too: against im2col_torch, timed
    beside it and F.unfold where that computes the same. Returns per
    kernel: launches, routes, distinct calls, ms, host_ms, plain_ms,
    library_ms, bound terms."""
    gen = torch.Generator().manual_seed(seed)
    counts = Counter(_call_key(n, a) for n, a in calls)
    first = {}
    for n, a in calls:
        first.setdefault(_call_key(n, a), (n, a))
    out = {k: {'launches': 0, 'distinct': 0, 'ms': 0.0, 'host_ms': 0.0,
               'plain_ms': 0.0,
               'library_ms': 0.0 if k == 'wgrad_s8' else None,
               'bytes': 0, 'layout_bytes': 0, 'ops': 0, 'max_abs_err': 0.0,
               'routes': Counter(),
               'modes': Counter()}
           for k in ('quant_s8', 'wgrad_s8')}
    out['wgrad_s8']['ragged_ms'] = 0.0
    out['wgrad_s8']['library_null_reason'] = []
    out['quant_s8']['library_null_reason'] = (
        "no one PyTorch call computes the per-sample amax, the scale and "
        "the quantize")
    for k in ('by_mode_ms', 'by_mode_plain_ms', 'by_mode_bytes'):
        out['quant_s8'][k] = Counter()
    # 'dequant' apart: its own kernel, bound and library call
    dq = out['quant_s8']['dequant'] = {
        'launches': 0, 'distinct': 0, 'ms': 0.0, 'host_ms': 0.0,
        'plain_ms': 0.0, 'library_ms': 0.0, 'library_differs': [],
        'bytes': 0}
    # the gather of wgrad_s8's ragged route apart: its own kernel, one
    # launch a ragged call
    im = out['im2col_s8'] = {
        'launches': 0, 'distinct': 0, 'ms': 0.0, 'host_ms': 0.0,
        'plain_ms': 0.0, 'library_ms': 0.0, 'library_null_reason': None,
        'bytes': 0, 'ops': 0, 'max_abs_err': 0.0}
    group, cleanup = _actq_world(dev)
    cuda = dev.type == 'cuda'
    try:
        for key, (name, args) in first.items():
            c = counts[key]
            row = out[name]
            row['launches'] += c
            row['distinct'] += 1
            row['bytes'] += c * actq_bytes(name, args)
            row['layout_bytes'] += c * actq_layout_bytes(name, args)
            row['ops'] += c * actq_ops(name, args)
            kern, plain, s32, ops = actq_operands(name, args, dev, gen)
            want = plain()
            _must_equal_all(name, args, (s32 or kern)(), want)
            if name == 'wgrad_s8':
                row['routes'][args['route']] += c
                geo, plan = ops['geo'], ops['plan']
                f = kern()
                _must_equal_all(name, args, f, want.float()
                                * ops['alpha'].view(1, plan.ci, plan.kh,
                                                    plan.kw), 'f32 ')
                rplan = actq_cuda.wgrad_plan(args['q'], args['co'], *geo,
                                             route='ragged')
                rqgt = actq_cuda._qgt(ops['qg'], plan=rplan)
                ragged = (lambda: actq_cuda.wgrad_s8(
                    ops['q'], rqgt, *geo, ops['alpha'], plan=rplan))
                _must_equal_all(name, args, actq_cuda.wgrad_s8(
                    ops['q'], rqgt, *geo, plan=rplan), want, 'ragged ')
                if args['route'] == 'ragged':
                    im['launches'] += c
                    im['distinct'] += 1
                    im['bytes'] += c * actq_bytes('im2col_s8', args)
                    q = ops['q']
                    gather = (lambda: actq_cuda.im2col_s8(q, plan))
                    gather_plain = (lambda: actq_cuda.im2col_torch(
                        q, *geo, plan))
                    _must_equal_all('im2col_s8', args, gather(),
                                    gather_plain())
            else:
                row['modes'][args['mode']] += c
                row['by_mode_bytes'][args['mode']] += c * actq_bytes(
                    name, args)
                if args['mode'] == 'dequant':
                    dq['launches'] += c
                    dq['distinct'] += 1
                    dq['bytes'] += c * actq_bytes(name, args)
                if args['mode'] == 'g':
                    t, kw = ops['t'], ops['kw']
                    _must_equal_all(name, args, actq_cuda.quant_s8(
                        t, 'g', group=group, **kw), actq_cuda.quant_s8_torch(
                        t, 'g', group=group, **kw), 'group ')
            if not (timed and cuda):
                continue
            ms = graph_ms(kern)
            host = cuda_ms(kern, ACTQ_TIMED)
            plain_ms = cuda_ms(plain, 2, warmup=1)
            row['ms'] += c * ms
            row['host_ms'] += c * host
            row['plain_ms'] += c * plain_ms
            if name == 'wgrad_s8':
                p = actq_cuda.im2col_torch(ops['q'], *geo)
                try:
                    torch._int_mm(rqgt, p.t())
                except RuntimeError as e:
                    # _int_mm takes no N that is not a multiple of 8
                    row['library_null_reason'].append(
                        f"{args['q']} x {args['co']}: torch._int_mm "
                        f"raises: {str(e).splitlines()[0]}")
                else:
                    row['library_ms'] += c * graph_ms(
                        lambda: torch._int_mm(rqgt, p.t()))
                row['ragged_ms'] += c * graph_ms(ragged)
                del p
                if args['route'] == 'ragged':
                    im['ms'] += c * graph_ms(gather)
                    im['host_ms'] += c * cuda_ms(gather, ACTQ_TIMED)
                    im['plain_ms'] += c * cuda_ms(gather_plain, 2, warmup=1)
                    unfold, reason = im2col_library(q, plan, gather())
                    if unfold is None:
                        im['library_null_reason'] = reason
                    else:
                        im['library_ms'] += c * graph_ms(unfold)
            else:
                row['by_mode_ms'][args['mode']] += c * ms
                row['by_mode_plain_ms'][args['mode']] += c * plain_ms
            if args.get('mode') == 'dequant':
                dq['ms'] += c * ms
                dq['host_ms'] += c * host
                dq['plain_ms'] += c * plain_ms
                # the one PyTorch call of the same function, the yardstick
                # only where it gives the plain version's bits
                t, kw = ops['t'], ops['kw']
                mul = (lambda: torch.mul(t, kw['scale'].to(kw['dtype']).view(
                    (-1,) + (1,) * (t.dim() - 1))))
                if torch.equal(mul(), want):
                    dq['library_ms'] += c * graph_ms(mul)
                else:
                    dq['library_differs'].append(str(args['shape']))
            del kern, plain, s32, ops
    finally:
        cleanup()
    for k, row in out.items():
        row.update(_bound(row['ops'], row['bytes'], INT8_OP_PER_S))
    q8 = out['quant_s8']
    q8['by_mode_bound_ms'] = {m: _bound(0, b, INT8_OP_PER_S)['bound_ms']
                              for m, b in q8['by_mode_bytes'].items()}
    dq.update(_bound(0, dq['bytes'], INT8_OP_PER_S))
    dq['bound_share'] = dq['bound_ms'] / dq['ms'] if dq['ms'] else None
    if dq['library_differs']:
        dq['library_ms'] = None
    if out['wgrad_s8']['library_null_reason']:
        out['wgrad_s8']['library_ms'] = None
    im['bound_share'] = im['bound_ms'] / im['ms'] if im['ms'] else None
    if im['library_null_reason']:
        im['library_ms'] = None
    return out


def im2col_library(q, plan, p):
    """The one PyTorch call that computes the gather's patch matrix `p`
    from the same int8 q, where there is one: F.unfold, whose [N, R, L] is
    P for one sample under symmetric pads. Returns (fn, None) where it
    gives p's bits, else (None, why not)."""
    (pt, pb), (pl, pr) = plan.pads
    if plan.n != 1 or (pt, pl) != (pb, pr):
        return None, ("F.unfold writes [N, Ci*KH*KW, L], P's layout only "
                      "for one sample under symmetric pads")

    def unfold():
        return F.unfold(q, (plan.kh, plan.kw), padding=(pt, pl),
                        stride=plan.stride)
    try:
        u = unfold()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"F.unfold on int8 raises: {str(e).splitlines()[0]}"
    if not torch.equal(u[0], p[:, :u.shape[-1]]):
        return None, "F.unfold differs from the gather"
    return unfold, None


def actq_expected(cfg, mode) -> dict:
    """The launches a train step of `cfg` makes under TRAIN_ACT_Q8 `mode`,
    from the backbone's convs (`memory.backbone_blocks`) and the routes'
    rules: one 'x' a conv, and again for each conv that REMAT's
    checkpoints recompute (`memory.recomputed`); under
    True one 'dequant' a conv; under 'wgrad8' one 'g' and one wgrad_s8 a
    conv within the int32 guard (N * Ho * Wo, N the global batch), on the
    'tma' route from 64 input channels (else 'ragged': one gather and one
    gemm_s8), and one 'dequant' for each of the others."""
    groups = memory.backbone_blocks(cfg)
    convs = [conv for g in groups for conv, _ in g]
    again = sum(memory.recomputed(part, getattr(cfg, 'REMAT', False))
                for g in groups for _, part in g)
    want = dict.fromkeys(('quant_s8_x', 'quant_s8_g', 'quant_s8_dequant',
                          'wgrad_s8_tma', 'wgrad_s8_ragged'), 0)
    if not mode:
        return want
    want['quant_s8_x'] = len(convs) + again
    for n, ci, h, w, co, k, st, p in convs:
        ho, wo = int8_cuda.conv_out_hw(h, w, k, k, st, ((p, p), (p, p)))
        if mode == 'wgrad8' and n * ho * wo <= actq_cuda.INT32_SAFE_ACC:
            want['quant_s8_g'] += 1
            want[f'wgrad_s8_{actq_cuda.wgrad_route(ci)}'] += 1
        else:
            want['quant_s8_dequant'] += 1
    return want


def _actq_launches() -> dict:
    """TRAIN_ACT_Q8's counters since the last reset, by wrapper, mode,
    route and kernel, with gemm_s8's and the fused warp's."""
    return {**actq_cuda.launches,
            **{f'quant_s8_{k}': v
               for k, v in actq_cuda.mode_launches.items()},
            **{f'wgrad_s8_{k}': v
               for k, v in actq_cuda.route_launches.items()},
            **{f'kernel_{k}': v
               for k, v in actq_cuda.kernel_launches.items()},
            'gemm_s8': int8_cuda.launches['gemm_s8'],
            'warp_mold': warp_cuda.launches['warp_mold']}


def _reset_launches() -> None:
    warp_cuda.reset_counts()
    int8_cuda.reset_counts()
    actq_cuda.reset_counts()


def add_actq_rows(rows, launches) -> None:
    """A path's launches added to the kernels line's rows: quant_s8
    (every mode), its 'dequant' kernel, wgrad_s8, the ragged route's
    gather and its gemm_s8 (the f32 epilogue)."""
    for row, k in (('quant_s8', 'quant_s8'), ('dequant', 'kernel_dequant'),
                   ('wgrad_s8', 'wgrad_s8'), ('im2col_s8', 'kernel_im2col'),
                   ('gemm_s8_f32acc', 'gemm_s8')):
        rows[row] += launches[k]


def _recorded_counts(calls) -> dict:
    """A step's recorded calls counted as `actq_expected` counts them."""
    got = Counter()
    for name, a in calls:
        got[f"quant_s8_{a['mode']}" if name == 'quant_s8'
            else f"wgrad_s8_{a['route']}"] += 1
    return got


def check_actq_counts(tag, mode, want, per_step, calls, cuda) -> None:
    """A step's launches (the card's counters over the path's steps, per
    step) and its recorded calls (on any device) against `actq_expected`;
    each quantize, dequant, TMA product and gather one kernel launch a
    call, the ragged route's product one gemm_s8; raises on a
    difference."""
    got = _recorded_counts(calls) if calls is not None else None
    if got is not None and any(got[k] != v for k, v in want.items()):
        raise RuntimeError(f"actq [{tag}]: the step's calls {dict(got)} are "
                           f"not the expected {want}")
    if not cuda:
        return
    bad = {k: (per_step[k], v) for k, v in want.items() if per_step[k] != v}
    if bad:
        raise RuntimeError(f"actq [{tag}]: launches a step (got, expected) "
                           f"{bad}")
    if per_step['kernel_quant_x'] != per_step['quant_s8_x'] \
            or per_step['kernel_quant_g'] != per_step['quant_s8_g'] \
            or per_step['kernel_dequant'] != per_step['quant_s8_dequant'] \
            or per_step['kernel_im2col'] != per_step['wgrad_s8_ragged'] \
            or per_step['gemm_s8'] != per_step['wgrad_s8_ragged'] \
            or per_step['kernel_wgrad_tma'] != per_step['wgrad_s8_tma']:
        raise RuntimeError(f"actq [{tag}]: launches do not add up "
                           f"({per_step})")
    if mode is False and (per_step['quant_s8'] or per_step['wgrad_s8']):
        raise RuntimeError(f"actq [{tag}] launched {per_step}")


def log_actq_kernels(tag, kernels, card, timed) -> None:
    """One line per kernel of check_actq_calls' result."""
    for k in ('quant_s8', 'wgrad_s8'):
        row = kernels[k]
        log(f"actq [{tag}] {k}: {row['launches']} launches a step "
            f"({row['distinct']} distinct calls, each equal to the "
            f"plain version on fresh operands"
            + (", on both routes" if k == 'wgrad_s8' else
               ", 'g' under a group too") + "); "
            + (f"routes {dict(row['routes'])}" if k == 'wgrad_s8'
               else f"modes {dict(row['modes'])}")
            + (f"; device {row['ms']:.4f} ms a step (graph), host "
               f"pace {row['host_ms']:.4f} ms, plain "
               f"{row['plain_ms']:.4f} ms, bound "
               f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
               f"{row['bytes']} B plain, {row['ops']} op; the "
               f"layouts add {row['layout_bytes']} B), library "
               + (f"{row['library_ms']} ms" if row['library_ms'] is not None
                  else f"not timed: {row.get('library_null_reason')}")
               + (f", ragged route {row['ragged_ms']:.4f} ms"
                  if k == 'wgrad_s8' else
                  f", by mode {dict(row['by_mode_ms'])}, plain by "
                  f"mode {dict(row['by_mode_plain_ms'])}, bound by "
                  f"mode {row['by_mode_bound_ms']}")
               + f" {card}" if timed else ""))
    dq = kernels['quant_s8']['dequant']
    if dq['launches'] and timed:
        log(f"actq [{tag}] quant_s8 'dequant': {dq['launches']} "
            f"launches a step ({dq['distinct']} distinct calls); "
            f"device {dq['ms']:.4f} ms a step (graph), host pace "
            f"{dq['host_ms']:.4f} ms, plain {dq['plain_ms']:.4f} ms, "
            f"bound {dq['bound_ms']:.4f} ms ({dq['bytes']} B), "
            f"{dq['bound_share']:.3f} of it; torch.mul "
            + (f"{dq['library_ms']:.4f} ms" if dq['library_ms']
               is not None else "differs from the plain version at "
               f"{dq['library_differs']}: not timed")
            + f" {card}")
    im = kernels['im2col_s8']
    if im['launches']:
        log(f"actq [{tag}] im2col_s8 (the ragged route's gather): "
            f"{im['launches']} launches a step ({im['distinct']} distinct "
            "calls, each equal to im2col_torch on fresh operands)"
            + (f"; device {im['ms']:.4f} ms a step (graph), host pace "
               f"{im['host_ms']:.4f} ms, plain {im['plain_ms']:.4f} ms, "
               f"bound {im['bound_ms']:.4f} ms ({im['bytes']} B), "
               f"{im['bound_share']:.3f} of it; F.unfold "
               + (f"{im['library_ms']:.4f} ms" if im['library_ms']
                  is not None else f"not timed: {im['library_null_reason']}")
               + f" {card}" if timed else ""))


def actq_memory(tag, cfg, peak, card, held: int = 0) -> dict:
    """One step's peak beside check_train_memory's estimate (the int8
    saved copies its actq_saved_gb part); where the mode is calibrated
    (`memory.calibrated`), outside ±25% the run fails."""
    est = memory.calibrated_train_gb(cfg)
    saved = memory.actq_saved_gb(cfg)
    ratio = est * 1e9 / peak
    gap = memory.calibration_gap(cfg)
    log(f"actq [{tag}] one step's peak {peak} bytes ({peak / 2**30:.2f} "
        f"GiB{f', above {held} bytes held before' if held else ''}) vs "
        f"check_train_memory's estimate {est:.3f} GB, of which the int8 "
        f"saved copies and their layout {saved:.3f} GB: {ratio:.3f} "
        + ("(tol 0.75-1.25)" if gap is None else f"(not gated: {gap})")
        + f" {card}")
    if gap is None and not 0.75 <= ratio <= 1.25:
        raise RuntimeError(f"actq [{tag}]: the calibrated estimate is "
                           f"{ratio:.3f} of the peak")
    return {'peak': peak, 'estimate_gb': est, 'actq_saved_gb': saved,
            'ratio': ratio}


def run_actq(device, seed: int = 0, card: str = '', cfg=None,
             steps: int = ACTQ_STEPS, timed: bool = True,
             tag: str = 'F16 flagship') -> dict:
    """One recipe of phase 8g: `cfg` (default the F16 flagship) under
    TRAIN_ACT_Q8 False, True and 'wgrad8' in turns: each `steps` train
    steps + 1 validation step from the same seeded weights and batch (the
    first step's loss equal across the modes: the forward is exact; a
    keypoint model's validation decoded by the keypoint SVD), the
    launches of quant_s8 by mode and by kernel (one a call for 'x' and
    'g': no fill launch), of wgrad_s8 by route, of the gather and of
    their GEMMs, a step's equal to `actq_expected`, every distinct call
    of one step held against the plain version, and on the card the
    median step time and one step's peak memory beside the estimate.
    Under REMAT: the gradients of each policy equal to those without
    (the recompute quantizes the forward's bits), and the modes of
    ACTQ_NO_REMAT stepped once more without REMAT, their launches and on
    the card their step time and peak. Returns per mode the numbers, and
    the kernel rows of 'wgrad8' (and True)."""
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    timed = timed and cuda
    cfg = cfg or flagship_config(f16=True)
    out = {'modes': {}, 'rows': Counter(), 'fused_err': 0.0, 'tag': tag}
    for mode in ACTQ_MODES:
        c = copy.deepcopy(cfg)
        c.TRAIN_ACT_Q8 = mode
        c.update()
        mtag = f"{tag} TRAIN_ACT_Q8={mode}"
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with _FusedWarps() as fused:
            res = run_main_path(c, dev, seed, steps)
        if cuda:
            torch.cuda.synchronize()
            out['fused_err'] = max(out['fused_err'], check_fused_call(
                f"actq [{mtag}]", fused.first))
        del fused
        launches = _actq_launches()
        out['rows']['warp_mold'] += launches['warp_mold']
        losses = [m['loss'] for m in res['train']]
        log(f"actq [{mtag}] losses: " + " ".join(f"{v:.6f}" for v in losses)
            + f"; validation {res['val']}; launches {launches}")
        check_main_path(res)
        if c.REGRESS_KEYPOINTS:
            sc = decode_keypoint_validation(res, c, seed)['scores']
            log(f"actq [{mtag}] validation decoded by the keypoint SVD: "
                f"mean ESA {sc['mean_esa']:.4f} (random weights)")
        per_step = {k: v // steps for k, v in launches.items()
                    if k not in ('warp_mold',)}
        want = actq_expected(c, mode)
        info = {'losses': losses, 'launches': launches,
                'per_step': per_step, 'expected': want}
        calls = None
        if mode:
            # one more step with the calls recorded: each distinct one
            actq_cuda.calls = []
            res['step'](res['raw'], torch.Generator().manual_seed(seed + 1))
            calls, actq_cuda.calls = actq_cuda.calls, None
        check_actq_counts(mtag, mode, want, per_step, calls, cuda)
        log(f"actq [{mtag}] a step: {want} as expected from the convs, "
            "REMAT's recompute and the routes")
        if mode:
            info['kernels'] = check_actq_calls(calls, dev, seed, timed)
            log_actq_kernels(mtag, info['kernels'], card, timed)
            add_actq_rows(out['rows'], launches)
        if timed:
            info['ms'] = time_train(res, seed)
            log(f"actq [{mtag}] step: median {info['ms']:.3f} ms over 10 "
                f"after 2 warm-up, {c.BATCH_SIZE / info['ms'] * 1e3:.2f} "
                f"imgs/s, batch {c.BATCH_SIZE} {c.IMAGE_SHAPE[0]}x"
                f"{c.IMAGE_SHAPE[1]} {card}")
            info.update(actq_memory(mtag, c, step_peak(res, seed), card))
        if c.REMAT and mode:
            rels = remat_grad_rel(res, seed, c.REMAT)
            log(f"actq [{mtag}] gradients of one forward under each REMAT "
                f"policy vs without REMAT, largest relative L2 over the "
                f"parameters (tol {REMAT_CARD_REL}): {rels}")
            if not max(rels.values()) <= REMAT_CARD_REL:
                raise RuntimeError(f"actq [{mtag}]: REMAT changed the "
                                   f"gradients: {rels}")
        if c.REMAT and mode in ACTQ_NO_REMAT:
            info['no_remat'] = actq_no_remat(res, c, mode, mtag, seed, dev,
                                             card, timed)
        out['modes'][mode] = info
        del res
    first = {m: v['losses'][0] for m, v in out['modes'].items()}
    if len(set(first.values())) != 1 or not np.isfinite(first[False]):
        raise RuntimeError(f"actq [{tag}]: the first step's losses differ: "
                           f"{first}")
    log(f"actq [{tag}]: the first step's loss {first[False]!r} in every mode "
        "(the forward is exact)")
    return out


def actq_no_remat(res, c, mode, mtag, seed, dev, card, timed) -> dict:
    """`res`'s model and batch without REMAT: one step's launches against
    `actq_expected` and, on the card, the step time and one step's peak
    beside the estimate. The model is left under `c.REMAT`."""
    plain = copy.deepcopy(c)
    plain.REMAT = False
    plain.update()
    ntag = f"{mtag} REMAT=False"
    res['model'].backbone.set_remat(False)
    try:
        _reset_launches()
        calls = [] if mode else None
        actq_cuda.calls = calls
        res['step'](res['raw'], torch.Generator().manual_seed(seed + 1))
        actq_cuda.calls = None
        if dev.type == 'cuda':
            torch.cuda.synchronize()
        per_step = {k: v for k, v in _actq_launches().items()
                    if k != 'warp_mold'}
        want = actq_expected(plain, mode)
        check_actq_counts(ntag, mode, want, per_step, calls,
                          dev.type == 'cuda')
        info = {'per_step': per_step, 'expected': want}
        log(f"actq [{ntag}] a step: {want} as expected")
        if timed:
            info['ms'] = time_train(res, seed)
            log(f"actq [{ntag}] step: median {info['ms']:.3f} ms over 10 "
                f"after 2 warm-up, batch {c.BATCH_SIZE} {card}")
            info.update(actq_memory(ntag, plain, step_peak(res, seed), card))
    finally:
        actq_cuda.calls = None
        res['model'].backbone.set_remat(c.REMAT)
    return info


class _FirstStep:
    """While open, keeps the metrics of the first step of the train steps
    that the engine makes (`engine.make_train_step`)."""

    def __enter__(self):
        from ursonet_torch import engine as engine_mod
        self.module = engine_mod
        self.saved = engine_mod.make_train_step
        self.metrics = None

        def make(*a, **kw):
            step = self.saved(*a, **kw)

            def run(*sa, **skw):
                m = step(*sa, **skw)
                if self.metrics is None:
                    self.metrics = {k: float(v) for k, v in m.items()}
                return m
            return run
        engine_mod.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_train_step = self.saved


def run_actq_cli(root, device, seed: int = 0, card: str = '',
                 flags=CONFIG2_FLAGS, steps: int = CONFIG2_STEPS,
                 batch: int = 1, timed: bool = True) -> dict:
    """Phase 8g's command-line recipe: benchmark config 2 (`flags`, batch
    `batch`) through `run_cli` on the URSO frames under `root/urso`
    (train `steps` steps streamed through the native loader, then
    evaluate --weights last) under --set TRAIN_ACT_Q8=False, True and
    wgrad8 in turns from the same seed: the first train step's loss equal
    across the modes, the launches a step equal to `actq_expected` of the
    command's Config (at batch 1 the C = 3 stem's weight gradient within
    the int32 guard: the ragged route, one gather and one gemm_s8), every
    distinct call of a step held against its plain version and timed on
    the card, the train command's peak beside the estimate (ResNet-18:
    not calibrated, printed), each command's seconds."""
    from ursonet_torch import pose_estimator
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    timed = timed and cuda
    out = {'modes': {}, 'rows': Counter(), 'fused_err': 0.0,
           'tag': 'config2 CLI'}
    for mode in ACTQ_MODES:
        mflags = list(flags) + ['--set', f'TRAIN_ACT_Q8={mode}']
        mtag = f"config2 CLI TRAIN_ACT_Q8={mode}"
        args = pose_estimator.build_parser().parse_args(
            ['train', '--dataset', 'urso', '--data_dir', root, '--weights',
             'none', '--batch_size', str(batch)] + mflags)
        c = pose_estimator.make_config(args)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() if cuda else 0
        actq_cuda.reset_counts()
        actq_cuda.calls = []
        try:
            with _FirstStep() as first, _NativeBatches() as native:
                cli = run_cli(root, dev, seed, flags=mflags,
                              train_batch=batch, eval_batch=batch,
                              steps=steps, card=card,
                              name=f'actq_config2_{mode}', float_only=True)
        finally:
            calls, actq_cuda.calls = actq_cuda.calls, None
        peak = torch.cuda.max_memory_allocated() - held if cuda else 0
        check_native_batches(f'{mtag} train', native)
        out['fused_err'] = max(out['fused_err'], cli['fused_err'])
        train_launches = cli['launches']['train']
        launches = {**_actq_launches(), 'gemm_s8': train_launches['gemm_s8'],
                    'warp_mold': train_launches['warp_mold']}
        if len(calls) % steps:
            raise RuntimeError(f"actq [{mtag}]: {len(calls)} calls in "
                               f"{steps} steps")
        step_calls = calls[:len(calls) // steps]
        per_step = {k: v // steps for k, v in launches.items()
                    if k != 'warp_mold'}
        want = actq_expected(c, mode)
        check_actq_counts(mtag, mode, want, per_step,
                          step_calls if mode else None, cuda)
        loss = first.metrics['loss']
        if not np.isfinite(loss):
            raise RuntimeError(f"actq [{mtag}]: first step's loss {loss}")
        info = {'first_loss': loss, 'launches': launches,
                'per_step': per_step, 'expected': want,
                'seconds': cli['seconds'], 'peak': peak,
                'evaluate_summary': None}
        log(f"actq [{mtag}] first train step {first.metrics}; a step: "
            f"{want} as expected; train and evaluate seconds "
            f"{ {k: round(v, 2) for k, v in cli['seconds'].items()} } "
            f"(host wall) {card}")
        if cuda:
            info.update(actq_memory(f"{mtag} train command", c, peak, card,
                                    held))
        if mode:
            info['kernels'] = check_actq_calls(step_calls, dev, seed, timed)
            log_actq_kernels(mtag, info['kernels'], card, timed)
            add_actq_rows(out['rows'], launches)
        out['rows']['warp_mold'] += launches['warp_mold']
        out['modes'][mode] = info
    first = {m: v['first_loss'] for m, v in out['modes'].items()}
    if len(set(first.values())) != 1:
        raise RuntimeError(f"actq [config2 CLI]: the first step's losses "
                           f"differ: {first}")
    log(f"actq [config2 CLI]: the first train step's loss {first[False]!r} "
        "in every mode (the forward is exact)")
    return out


def actq_recipes() -> tuple:
    """Phase 8g's recipes run by `run_actq`, as (tag, Config): the F16
    flagship, benchmark_config(5) (ResNet-101, keypoints, F16, REMAT,
    batch 16) and the f32 flagship (batch 32); config 2 runs through the
    command line (`run_actq_cli`) between the last two."""
    return (('F16 flagship', flagship_config(f16=True)),
            ('config5', presets.benchmark_config(5)),
            ('f32 flagship', flagship_config(f16=False)))


def run_actq_phase(root, device, seed: int = 0, card: str = '',
                   recipes=None, cli_flags=CONFIG2_FLAGS,
                   cli_steps: int = CONFIG2_STEPS, steps: int = ACTQ_STEPS,
                   timed: bool = True) -> dict:
    """Phase 8g: TRAIN_ACT_Q8 in the recipes the JAX package trains it
    with: each of `recipes` (default actq_recipes()) through `run_actq`,
    and config 2 through the command line (`run_actq_cli`, on the frames
    under `root/urso`) after the second. Returns per recipe its result,
    and the launches by kernel row summed."""
    recipes = actq_recipes() if recipes is None else recipes
    out = {'recipes': {}, 'rows': Counter(), 'fused_err': 0.0}
    for i, (tag, cfg) in enumerate(recipes):
        t0 = time.perf_counter()
        r = run_actq(device, seed, card, cfg=cfg, steps=steps, timed=timed,
                     tag=tag)
        out['recipes'][tag] = r
        log(f"actq [{tag}]: {time.perf_counter() - t0:.1f} s")
        if i == 1:
            t0 = time.perf_counter()
            r = run_actq_cli(root, device, seed, card, flags=cli_flags,
                             steps=cli_steps, timed=timed)
            out['recipes'][r['tag']] = r
            log(f"actq [{r['tag']}]: {time.perf_counter() - t0:.1f} s")
    for r in out['recipes'].values():
        out['rows'].update(r['rows'])
        out['fused_err'] = max(out['fused_err'], r['fused_err'])
        if torch.device(device).type == 'cuda':
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 8h: test --video

VIDEO_FRAMES = 24
VIDEO_WH = (1280, 960)
VIDEO_FPS = 10.0
VIDEO_BATCH = 8


def run_video(root, device, seed: int = 0, card: str = '',
              frames: int = VIDEO_FRAMES, wh=VIDEO_WH, flags=CLI_FLAGS,
              batch: int = VIDEO_BATCH) -> dict:
    """Phase 8h: a clip of `frames` synthetic URSO frames (`wh`, the
    labelled 'test' subset of a dataset under `root/video`) written by the
    port's AVI writer, then `test --video` through the CLI float and
    `--int8 --f16`: every frame written, each frame's pose equal to
    `engine.detect` on the reader's frames in the same batches, frames/s
    and its split into decode, serve, draw and encode."""
    from ursonet_torch import pose_estimator, video
    from ursonet_torch.data.avi import AviReader, AviWriter
    dev = torch.device(device)
    cuda = dev.type == 'cuda'
    data_dir = os.path.join(root, 'video')
    make_urso_dataset(os.path.join(data_dir, 'clip'), subsets=('test',),
                      n_per_subset=frames, width=wh[0], height=wh[1],
                      seed=seed + 7)
    ds = Urso()
    ds.load_dataset(os.path.join(data_dir, 'clip'), Config(), 'test')
    clip = os.path.join(root, 'clip.avi')
    t0 = time.perf_counter()
    w = AviWriter(clip, VIDEO_FPS)
    for i in ds.image_ids:
        w.append(ds.load_image(i))
    w.close()
    log(f"video: {frames} frames of {wh[0]}x{wh[1]} written to an MJPG AVI "
        f"of {os.path.getsize(clip)} bytes in {time.perf_counter() - t0:.2f}"
        " s (PNG read and JPEG encode, host)")
    reader = AviReader(clip)
    clip_frames = list(reader)
    reader.close()
    out = {'rows': Counter(), 'runs': {}}
    for tag, extra in (('float', []), ('int8 f16', ['--int8', '--f16'])):
        seen, drawn = {}, []
        real_detect, real_overlay = video.detect_video, video.overlay_axes

        def spy(engine, dataset, *a, **kw):
            seen['engine'], seen['dataset'] = engine, dataset
            seen['timings'] = kw['timings'] = {}
            return real_detect(engine, dataset, *a, **kw)

        def overlay(frame, K, loc, q, conv, scale=1.0):
            drawn.append((np.array(loc), np.array(q)))
            return real_overlay(frame, K, loc, q, conv, scale)

        out_dir = os.path.join(root, f"video_out_{tag.replace(' ', '_')}")
        argv = ['test', '--dataset', 'clip', '--data_dir', data_dir,
                '--logs', os.path.join(root, 'video_logs'), '--out_dir',
                out_dir, '--weights', 'none', '--eval_batch', str(batch),
                '--seed', str(seed), '--video', clip] + list(flags) + extra
        warp_cuda.reset_counts()
        int8_cuda.reset_counts()
        video.detect_video, video.overlay_axes = spy, overlay
        t0 = time.perf_counter()
        try:
            rc = pose_estimator.main(argv, device=dev)
        finally:
            video.detect_video, video.overlay_axes = real_detect, real_overlay
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"video [{tag}]: exit code {rc}")
        launches = {**int8_cuda.launches}
        path = os.path.join(out_dir, 'clip.avi_annotated.avi')
        r = AviReader(path)
        n_out = sum(1 for _ in r.chunks())
        r.close()
        if n_out != frames or len(drawn) != frames:
            raise RuntimeError(f"video [{tag}]: {n_out} frames written, "
                               f"{len(drawn)} drawn of {frames}")
        if extra and cuda and min(launches['gemm_s8'],
                                  launches['conv_s8']) < 1:
            raise RuntimeError(f"video [{tag}]: launches {launches}")
        # the poses against engine.detect on the reader's frames
        eng = seen['engine']
        if eng.config.BATCH_SIZE != batch:
            raise RuntimeError(f"video [{tag}]: batch {eng.config.BATCH_SIZE}")
        worst = 0.0
        for i in range(0, frames, batch):
            chunk = clip_frames[i:i + batch]
            chunk = chunk + [chunk[-1]] * (batch - len(chunk))
            outs = eng.detect(chunk)
            raw = {k: np.stack([o[k] for o in outs]) for k in outs[0]}
            locs, qs = evaluate.decode_dataset_results(raw, eng.config,
                                                       seen['dataset'])
            for j in range(min(batch, frames - i)):
                loc, q = drawn[i + j]
                worst = max(worst, float(np.abs(loc - locs[j]).max()),
                            float(np.abs(q - qs[j]).max()))
        if worst != 0.0:
            raise RuntimeError(f"video [{tag}]: poses differ from "
                               f"engine.detect's by {worst}")
        t = seen['timings']
        split = {k: t[k] for k in video.TIMED}
        busy = sum(split.values())
        log(f"video [{tag}] test --video: {n_out} frames written, each pose "
            f"equal to engine.detect's on the reader's frames; "
            f"{frames / busy:.2f} frames/s over detect_video's {busy:.2f} s "
            f"(" + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
            + f"), the command {wall:.1f} s with model build and "
            f"calibration; launches {launches} {card}")
        sfx = '' if '--f16' in extra else '_f32acc'
        if extra:
            out['rows'].update(launch_rows(launches, sfx))
        out['runs'][tag] = {'frames_per_s': frames / busy, 'split': split,
                            'wall': wall}
        del seen, eng
    return out


def actq_kernel_rows(aqp) -> list:
    """The kernels line's rows of phase 8g (`run_actq_phase`'s result;
    the first recipe's 'wgrad8' step gives the times, True's beside
    them)."""
    keys = LINE_KEYS
    # TRAIN_ACT_Q8's kernels (phase 8g), which replace XLA operations of
    # the JAX package, no Pallas kernel: the F16 flagship's train step
    # under 'wgrad8' (quant_s8 'x' and 'g', wgrad_s8), each distinct call
    # timed on fresh operands by CUDA graph (device time; host_ms its host
    # pace) and weighted by its count; under True beside them (quant_s8
    # 'x' and 'dequant'). wgrad_s8 on the TMA route (implicit GEMM, no
    # patch matrix); its library call torch._int_mm on the patch matrix of
    # the same operands, and its ragged route (gather + gemm_s8) beside
    # it. Each recipe's launches by path and its step's times beside them.
    recipes = aqp['recipes']
    aq = next(iter(recipes.values()))
    rows = []

    def by_recipe(fn):
        return {tag: {str(m): fn(v) for m, v in r['modes'].items() if m}
                for tag, r in recipes.items()}

    def times(row):
        return {k: row[k] for k in keys + ('host_ms',)
                + (('library_null_reason',) if row['library_ms'] is None
                   else ())}
    for name, replaces in (('quant_s8', 'ursonet_tpu/models/actq.py:117'),
                           ('wgrad_s8', 'ursonet_tpu/models/actq.py:90')):
        w8 = aq['modes']['wgrad8']['kernels'][name]
        row = {"name": name, "route": "cuda",
               "source": "ursonet_torch/csrc/actq.cu", "replaces": replaces,
               "replaces_kind": "XLA operations of the JAX package (no "
                                "Pallas kernel)",
               "launches": aqp['rows'][name],
               "launches_by_path": {tag: r['rows'][name]
                                    for tag, r in recipes.items()},
               "launches_by_mode": {str(m): v['launches'][name]
                                    for m, v in aq['modes'].items()},
               "kernel_launches_by_mode": {
                   str(m): {k[len('kernel_'):]: n
                            for k, n in v['launches'].items()
                            if k.startswith('kernel_')}
                   for m, v in aq['modes'].items()},
               "per_step_by_path": by_recipe(lambda v: {
                   k: n for k, n in v['per_step'].items()
                   if k.startswith(name)}),
               "max_abs_err": 0.0,
               **{k: w8[k] for k in keys}, "host_ms": w8['host_ms'],
               "bound_bytes": w8['bytes'],
               "layout_extra_bytes": w8['layout_bytes'],
               "per": "train step, 'wgrad8', F16 flagship",
               "by_path": by_recipe(lambda v: times(v['kernels'][name]))}
        if name == 'quant_s8':
            row["launches_by_quant_mode"] = {
                str(m): {q: v['launches'][f'quant_s8_{q}']
                         for q in actq_cuda.MODES}
                for m, v in aq['modes'].items()}
            row["ms_by_quant_mode"] = dict(w8['by_mode_ms'])
            row["plain_ms_by_quant_mode"] = dict(w8['by_mode_plain_ms'])
            row["bound_ms_by_quant_mode"] = w8['by_mode_bound_ms']
            row["ms_by_quant_mode_by_path"] = by_recipe(
                lambda v: dict(v['kernels']['quant_s8']['by_mode_ms']))
            row["library_null_reason"] = (
                "no one PyTorch call computes the per-sample amax, the "
                "scale and the quantize")
            tr = aq['modes'][True]['kernels'][name]
            row["mode_true"] = {
                **{k: tr[k] for k in keys}, "host_ms": tr['host_ms'],
                "ms_by_quant_mode": dict(tr['by_mode_ms']),
                "plain_ms_by_quant_mode": dict(tr['by_mode_plain_ms']),
                "bound_ms_by_quant_mode": tr['by_mode_bound_ms']}
        else:
            row["launches_by_route"] = {
                tag: {str(m): {q: v['launches'][f'wgrad_s8_{q}']
                               for q in actq_cuda.ROUTES}
                      for m, v in r['modes'].items()}
                for tag, r in recipes.items()}
            row["ragged_route_ms"] = w8['ragged_ms']
        rows.append(row)
    # quant_s8 'dequant' apart (its own kernel, `_q8_bwd`'s copy
    # q.astype(dt) * scale.astype(dt)): a 'wgrad8' step's calls, True's
    # beside them; its library call one torch.mul on the same operands.
    # Its launches, times and bytes are also inside quant_s8's row.
    dqs = {m: aq['modes'][m]['kernels']['quant_s8']['dequant']
           for m in (True, 'wgrad8')}
    dq_keys = keys + ('host_ms', 'bound_share', 'library_differs')
    rows.append({
        "name": "quant_s8_dequant", "route": "cuda",
        "source": "ursonet_torch/csrc/actq.cu",
        "replaces": "ursonet_tpu/models/actq.py:157",
        "replaces_kind": "an XLA operation of the JAX package (no Pallas "
                         "kernel)",
        "included_in": "quant_s8",
        "launches": aqp['rows']['dequant'],
        "launches_by_path": {tag: r['rows']['dequant']
                             for tag, r in recipes.items()},
        "launches_by_mode": {str(m): v['launches']['kernel_dequant']
                             for m, v in aq['modes'].items()},
        "max_abs_err": 0.0,
        **{k: dqs['wgrad8'][k] for k in dq_keys},
        "bound_bytes": dqs['wgrad8']['bytes'],
        "per": "train step, 'wgrad8', F16 flagship",
        "mode_true": {k: dqs[True][k] for k in dq_keys + ('bytes',)},
        "by_path": by_recipe(lambda v: {
            k: v['kernels']['quant_s8']['dequant'][k] for k in dq_keys})})
    # the gather of wgrad_s8's ragged route (im2col_s8): config 2's stem
    # (C = 3) at batch 1 through the command line, a 'wgrad8' step's call
    im = recipes['config2 CLI']['modes']['wgrad8']['kernels']['im2col_s8']
    rows.append({
        "name": "im2col_s8", "route": "cuda",
        "source": "ursonet_torch/csrc/actq.cu",
        "replaces": "ursonet_tpu/models/actq.py:90",
        "replaces_kind": "the patches that XLA's conv of `_wgrad_conv` "
                         "reads (no Pallas kernel); the gather half of "
                         "wgrad_s8's ragged route",
        "included_in": "wgrad_s8",
        "launches": aqp['rows']['im2col_s8'],
        "launches_by_path": {tag: r['rows']['im2col_s8']
                             for tag, r in recipes.items()},
        "max_abs_err": 0.0,
        **{k: im[k] for k in keys + ('host_ms', 'bound_share')},
        "bound_bytes": im['bytes'],
        "library_null_reason": im['library_null_reason'],
        "per": "train step, 'wgrad8', config 2 (batch 1) through the CLI"})
    return rows


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
    fused_err = check_fused_warp(dev, rng, K, cfg.MEAN_PIXEL)
    t0 = time.perf_counter()
    int8_err = check_int8_kernels(dev, rng)
    stem_err = check_stem_kernel(dev, rng)
    block_err = check_block_kernel(dev)
    rate_err = check_mma_rate(dev)
    log(f"int8 and rate kernel checks: {time.perf_counter() - t0:.1f} s")

    # 4. train path
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_counts()
    with _FusedWarps() as fused:
        res = run_main_path(cfg, dev, args.seed, STEPS)
    torch.cuda.synchronize()
    launches = dict(warp_cuda.launches)
    log("train losses: " + " ".join(f"{m['loss']:.6f}" for m in res['train']))
    log(f"train step 0 metrics: {res['train'][0]}")
    log(f"train step {STEPS - 1} metrics: {res['train'][-1]}")
    log(f"validation metrics: {res['val']}")
    log(f"launches on the train path: {launches}")
    check_main_path(res)
    if launches['warp_mold'] < 1:
        raise RuntimeError("the train path never launched warp_mold")
    fused_err = max(fused_err, check_fused_call('train', fused.first))
    del fused
    peak = torch.cuda.max_memory_allocated()
    train_ms = time_train(res, args.seed)
    mem = {'f32 flagship': check_memory('f32 flagship', cfg,
                                        step_peak(res, args.seed), card)}
    # a holdout no factor was fitted on: the same step at half the batch
    half = FLAGSHIP_BATCH // 2
    cfg_half = flagship_config()
    cfg_half.IMAGES_PER_GPU = half
    cfg_half.update()
    res_half = {**res, 'raw': {k: v[:half] for k, v in res['raw'].items()}}
    res_half['step'](res_half['raw'], torch.Generator().manual_seed(0))
    mem[f'f32 flagship batch {half} (holdout)'] = check_memory(
        f'f32 flagship batch {half} (holdout)', cfg_half,
        step_peak(res_half, args.seed), card)
    del res_half
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
    mold_by_path = {'train_f32': launches['warp_mold']}
    cfg16 = flagship_config(f16=True)
    res = bf16_train(dev, cfg16, 'F16 flagship', args.seed, card)
    warp_by_path['train_f16'] = res['launches']['warp_homography']
    mold_by_path['train_f16'] = res['launches']['warp_mold']
    fused_err = max(fused_err, res['fused_err'])
    mem['F16 flagship'] = check_memory('F16 flagship', cfg16,
                                       res['peak_step'], card)
    log(f"train [F16 flagship] step {res['ms']:.3f} ms vs the f32 step "
        f"{train_ms:.3f} ms (phase 4) in this run, batch {FLAGSHIP_BATCH} "
        f"{card}")
    f16_ms = res['ms']
    del res
    # (b) benchmark_config(5): ResNet-101, keypoints, F16, REMAT
    cfg5 = presets.benchmark_config(5)
    res = bf16_train(dev, cfg5, 'config5 REMAT', args.seed, card)
    warp_by_path['train_config5'] = res['launches']['warp_homography']
    mold_by_path['train_config5'] = res['launches']['warp_mold']
    fused_err = max(fused_err, res['fused_err'])
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
    mem['config5 REMAT'] = check_memory('config5 REMAT', cfg5, peak[True],
                                        card)
    cfg5_plain = presets.benchmark_config(5)
    cfg5_plain.REMAT = False
    mem['config5 no REMAT'] = check_memory('config5 no REMAT', cfg5_plain,
                                           peak[False], card)
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
        mold_by_path['engine'] = eng['warp_mold_launches']
        fused_err = max(fused_err, eng['fused_err'])
        torch.cuda.empty_cache()
        log(f"engine phase: {time.perf_counter() - t6:.1f} s")

        # 7. the command line on the engine phase's frames
        t7 = time.perf_counter()
        cli = run_cli(root, dev, args.seed, card=card)
        fused_err = max(fused_err, cli['fused_err'])
        torch.cuda.empty_cache()
        log(f"cli phase: {time.perf_counter() - t7:.1f} s; seconds by "
            f"command { {k: round(v, 1) for k, v in cli['seconds'].items()} }"
            f" {card}")

        # 8. SPEED: benchmark config 4 from JPEG frames
        t8 = time.perf_counter()
        speed = run_speed(root, dev, args.seed, card=card)
        fused_err = max(fused_err, speed['fused_err'])
        torch.cuda.empty_cache()
        log(f"speed phase: {time.perf_counter() - t8:.1f} s; seconds by "
            f"part { {k: round(v, 1) for k, v in speed['seconds'].items()} }"
            f" {card}")

        # 8b. benchmark config 2 on the engine phase's frames
        t8 = time.perf_counter()
        c2 = run_config2(root, dev, args.seed, card=card)
        fused_err = max(fused_err, c2['cli']['fused_err'])
        torch.cuda.empty_cache()
        log(f"config2 phase: {time.perf_counter() - t8:.1f} s; seconds by "
            f"command "
            f"{ {k: round(v, 1) for k, v in c2['cli']['seconds'].items()} }"
            f"; evaluate images/s at batch 1 "
            f"{ {k: round(v, 2) for k, v in c2['cli']['imgs_per_s'].items()} }"
            f" {card}")

        # 8c. batch-statistics BN, the host-parity generator, DEBUG_NANS
        t8 = time.perf_counter()
        tb = run_trainbn(root, dev, args.seed, card=card,
                         ref_ms={'f32': train_ms, 'f16': f16_ms})
        fused_err = max(fused_err, tb['fused_err'])
        torch.cuda.empty_cache()
        log(f"trainbn phase: {time.perf_counter() - t8:.1f} s; TRAIN_BN=None "
            f"step f32 {tb['f32']['ms']:.3f} ms (frozen {train_ms:.3f}), F16 "
            f"{tb['f16']['ms']:.3f} ms (frozen {f16_ms:.3f}); peaks "
            f"{tb['f32']['peak']} / {tb['f16']['peak']} bytes; "
            f"--host_augment: generator {tb['host_loader_ips']:.2f} "
            f"images/s, step {tb['host_step_ips']:.2f} images/s, epoch "
            f"{tb['host_epoch_ips']:.2f} imgs/s {card}")

        # 8d. the serving knobs bench.py reads, and the pruned flagship
        t8 = time.perf_counter()
        kn = run_knobs(root, dev, args.seed, card=card)
        fused_err = max(fused_err, kn['fused_err'])
        torch.cuda.empty_cache()
        log(f"knobs phase: {time.perf_counter() - t8:.1f} s {card}")

        # 8e. the Orbax checkpoint store: train, resume and serve
        t8 = time.perf_counter()
        ob = run_orbax(root, dev, args.seed, card=card)
        fused_err = max(fused_err, ob['fused_err'])
        torch.cuda.empty_cache()
        log(f"orbax phase: {time.perf_counter() - t8:.1f} s {card}")

        # 8f. parallelism: a world of one under NCCL, a 2x2 gloo world
        par = run_parallel(root, dev, args.seed, card=card,
                           train_ms=train_ms)
        fused_err = max(fused_err, par['fused_err'])
        torch.cuda.empty_cache()
        log(f"parallel phase: {par['seconds']:.1f} s {card}")

        # 8g. TRAIN_ACT_Q8 in the recipes the JAX package trains it with:
        # the F16 flagship, config 5, config 2 (the command line) and the
        # f32 flagship
        t8 = time.perf_counter()
        aqp = run_actq_phase(root, dev, args.seed, card=card)
        aq = aqp['recipes']['F16 flagship']
        fused_err = max(fused_err, aqp['fused_err'])
        torch.cuda.empty_cache()
        log(f"actq phase: {time.perf_counter() - t8:.1f} s; step "
            + "; ".join(f"{tag}: " + ", ".join(
                f"TRAIN_ACT_Q8={m} {v['ms']:.3f} ms (peak "
                f"{v['peak'] / 2**30:.2f} GiB)"
                + (f", without REMAT {v['no_remat']['ms']:.3f} ms (peak "
                   f"{v['no_remat']['peak'] / 2**30:.2f} GiB)"
                   if 'no_remat' in v else '')
                for m, v in r['modes'].items())
                for tag, r in aqp['recipes'].items() if tag != 'config2 CLI')
            + f" {card}")

        # 8h. test --video on a clip of 1280x960 URSO frames
        t8 = time.perf_counter()
        vid = run_video(root, dev, args.seed, card=card)
        torch.cuda.empty_cache()
        log(f"video phase: {time.perf_counter() - t8:.1f} s; frames/s "
            + ", ".join(f"{k} {v['frames_per_s']:.2f}"
                        for k, v in vid['runs'].items()) + f" {card}")

    # 9. the committed artifact, under F16 and in the f32-epilogue mode
    for f16 in (True, False):
        serve_artifact(dev, f16)

    # 10. serving path at full width and batch: F16 (bench.py's mode) and
    # the f32-epilogue mode, in the base and host_s2d variants
    int8_launches, calls, serve_ms, stem_call = {}, {}, {}, {}
    nhwc_call = {}
    for f16 in (True, False):
        mode = 'bf16' if f16 else 'f32'
        for variant in ('base', 'host_s2d'):
            served = serve_flagship(dev, args.seed, variant, f16)
            tag = f"{variant} {mode}"
            if variant == 'base' and f16:
                # 10b. the served batch's copy through the staging ring
                check_staging(dev, served, card)
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
            # gemm_s8, conv_s8 and the stem's 'nhwc' route are counted
            # and timed on the base path, stem_s8's 'tma' route on the
            # host_s2d path
            for name, count in served['launches'].items():
                if (name == 'stem_s8') == (variant == 'host_s2d'):
                    int8_launches[name, mode] = count
            stem = next(a for n, a in served['calls'] if n == 'stem_s8')
            if variant == 'base':
                calls[mode] = served['calls']
                nhwc_call[mode] = stem
            else:
                stem_call[mode] = stem
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

    # 11. the kernel-probe entry points at their own shapes
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

    # 12. numbers per kernel
    # the fused warp on the traffic its train paths send: the flagship's
    # 32x512x640 u8 batch under benchmark_config(3) (camera rotations and
    # rolls, no image left as it is) and config 4's 4x1x640x960 gray plane
    # under benchmark_config(4) (camera rotations only: about half the
    # images left as they are), both interpolations; beside it the
    # unfused mode (kernel, F.grid_sample)
    fused_t = {}
    cfg4 = presets.benchmark_config(4)
    for name, (b, h, w), Kb, cfg_n, gray in (
            ('flagship', (FLAGSHIP_BATCH, 512, 640), K, cfg, False),
            ('gray', SPEED_TRAIN_SHAPE, speed_intrinsics(), cfg4, True)):
        src, draws = drawn_inputs(dev, rng, args.seed, cfg_n, b, h, w, Kb,
                                  gray, FUSED_TIMED_DRAWS)
        for interp in ('nearest', 'bilinear'):
            t = time_fused(src, draws, cfg_n.MEAN_PIXEL, interp)
            fused_t[name, interp] = t
            log_fused(f"{interp} {'gray' if gray else 'u8'} {b}x{h}x{w} "
                      f"(benchmark_config({3 if name == 'flagship' else 4}) "
                      f"draws)", t, card)
        del src, draws
    torch.cuda.empty_cache()
    on_path = fused_t['flagship', cfg.WARP_INTERPOLATION]
    gray = fused_t['gray', cfg4.WARP_INTERPOLATION]
    log(f"memory: calibrated estimate / measured peak {mem}")
    int8, stem, nhwc = {}, {}, {}
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
        nhwc[mode] = time_stem_nhwc(dev, rng, card, nhwc_call[mode])
        torch.cuda.empty_cache()
    float_fwd = time_float_forward(dev, args.seed, card)
    block = time_block(dev, card)
    rates = {(kind, route): time_mma_rate(kind, route, dev, card)
             for kind in mma_rate.KINDS for route in mma_rate.ROUTES}

    keys = LINE_KEYS
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
        # the 'nhwc' route: the `base` batch's stem section in one launch
        # (`chain_ms`: the unfused chain it replaced); the engine serves
        # benchmark_config(3) with f32 epilogues
        eng_nhwc = eng['int8_launches']['stem_s8_nhwc'] if mode == 'f32' \
            else 0
        int8_rows.append({
            "name": "stem_s8_nhwc" + sfx, "route": "cuda",
            "kernel_route": "nhwc", "acc": mode,
            "source": "ursonet_torch/csrc/int8_stem.cu",
            "replaces": "ursonet_tpu/models/quant.py:294, :307, :396",
            "launches": int8_launches['stem_s8_nhwc', mode] + eng_nhwc,
            **({"launches_by_path": {
                "serve_base": int8_launches['stem_s8_nhwc', mode],
                "engine": eng_nhwc}} if eng_nhwc else {}),
            "max_abs_err": stem_err,
            **{k: nhwc[mode][k] for k in timed_keys + ('chain_ms',)}})
    # The warp's row: the fused mode (warp_mold) at the flagship's u8 batch
    # on its interpolation and its configuration's drawn M and identity
    # flags, device time by CUDA graph (the mean over the draws,
    # `ms_min`/`ms_max` its spread), `host_ms` the pace
    # of back-to-back calls, `chain_ms` the unfused chain it replaced;
    # `gray` the same at config 4's plane; `unfused` the unfused mode at
    # the flagship's planes with F.grid_sample as its library call. No one
    # PyTorch call computes the fused function: library_ms null.
    fused_keys = keys + ('host_ms', 'ms_min', 'ms_max', 'draws',
                         'chain_ms', 'chain_host_ms', 'global_share',
                         'identity_share')
    unfused_keys = keys + ('host_ms', 'library_host_ms')
    kernels = [{
        "name": "warp_homography", "route": "cuda",
        "source": "ursonet_torch/csrc/warp.cu",
        "replaces": "ursonet_tpu/ops/warp_pallas.py:56",
        "launches": sum(warp_by_path.values()) + speed['rows'][
            'warp_homography'],
        "launches_by_path": {**warp_by_path,
                             'speed': speed['rows']['warp_homography']},
        "launches_fused_by_path": {**mold_by_path,
                                   'speed': speed['rows']['warp_mold']},
        "launches_gray": {'speed': speed['rows']['warp_homography_gray']},
        "max_abs_err": max(warp_err, fused_err),
        "max_abs_err_by_path": {"unfused checks": warp_err,
                                "fused checks and train paths": fused_err},
        **{k: on_path[k] for k in fused_keys},
        "gray": {k: gray[k] for k in fused_keys},
        "unfused": {k: on_path['unfused'][k] for k in unfused_keys},
        "gray_unfused": {k: gray['unfused'][k] for k in unfused_keys},
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
    # the command line's launches (phase 7), counted per command; a row
    # without paths had only its serving path's ('serve')
    for row in kernels:
        n = cli['rows'].get(row['name'], 0)
        if n:
            row.setdefault('launches_by_path', {'serve': row['launches']})
            row['launches_by_path']['cli'] = n
            row['launches'] += n
        # the SPEED phase's int8 launches (submit --int8) and its served
        # batches against the plain version; the warp's are in its row
        # already
        n = speed['rows'].get(row['name'], 0) \
            if row['name'] != 'warp_homography' else 0
        if n:
            row.setdefault('launches_by_path', {'serve': row['launches']})
            row['launches_by_path']['speed'] = n
            row['launches'] += n
            row.setdefault('max_abs_err_by_path',
                           {'checks': row['max_abs_err']})
            row['max_abs_err_by_path']['speed'] = speed['max_abs_err']
            row['max_abs_err'] = max(row['max_abs_err'],
                                     speed['max_abs_err'])
        # benchmark config 2's launches (phase 8b) and the TRAIN_BN
        # paths' (phase 8c)
        for path, got in (('config2', c2['rows']), ('trainbn', tb['rows']),
                          ('knobs', kn['rows']), ('orbax', ob['rows']),
                          ('parallel', par['rows']),
                          ('actq', {'gemm_s8_f32acc':
                                    aqp['rows']['gemm_s8_f32acc']}),
                          ('video', vid['rows'])):
            n = got.get(row['name'], 0)
            if n:
                row.setdefault('launches_by_path',
                               {'serve': row['launches']})
                row['launches_by_path'][path] = n
                row['launches'] += n
    kernels[0]['launches_fused_by_path']['cli'] = cli['rows']['warp_mold']
    kernels[0]['launches_fused_by_path']['config2'] = c2['rows']['warp_mold']
    kernels[0]['launches_fused_by_path']['trainbn'] = tb['rows']['warp_mold']
    kernels[0]['launches_fused_by_path']['knobs'] = kn['warp_mold']
    kernels[0]['launches_fused_by_path']['orbax'] = ob['rows']['warp_mold']
    kernels[0]['launches_fused_by_path']['parallel'] = par['rows'][
        'warp_mold']
    kernels[0]['launches_fused_by_path']['actq'] = aqp['rows']['warp_mold']
    # phase 8d's joins by mode and residual type, and its checks of them
    # (every distinct call on fresh operands: any difference raised)
    new_modes = int8_cuda.JOINS + ('f32_sum',)
    for row in kernels:
        joins = {f"{ep}/{res}": n for (k, ep, res), n in kn['joins'].items()
                 if k == row['name']}
        if joins:
            row['launches_by_join'] = {'knobs': joins}
        checked = {f"{ep}/{res}": 0.0
                   for (k, ep, res), n in kn['checked'].items()
                   if k == row['name'] and ep in new_modes}
        if checked:
            row['max_abs_err_by_mode'] = checked
    # train --host_augment warps on the host: checked to launch none
    kernels[0]['launches_fused_by_path']['host_augment'] = 0
    kernels += actq_kernel_rows(aqp)
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
