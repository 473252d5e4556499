"""Pre-flight estimate of a train step's device memory, the counterpart
of `ursonet_tpu/utils/memory.py`.

`estimate_train_hbm_gb` is the JAX package's structural estimate, kept
equal to it:

  * saved forward activations (every residual block's ReLU outputs kept
    for the backward), in the compute dtype (a 0.15 share of them under
    REMAT);
  * parameters, gradients and optimizer slots (f32);
  * the input batch.

It counts what XLA's fused step holds. The eager PyTorch step holds
more (autograd keeps every op's saved inputs, cuDNN its workspaces), so
`calibrated_train_gb` multiplies it by a factor per mode,
`EAGER_FACTORS`, the ratio of the measured peak
(`torch.cuda.max_memory_allocated` over one train step) to the estimate
on an NVIDIA H100 80GB HBM3 at a 700 W power limit (`chip_smoke.py`
phases 4-6, which print both for each configuration):

  * 'f32'   1.82: the flagship (`benchmark_config(3)`, batch 32) peaks at
            17.57 GiB = 18.87 GB against 10.41 GB (1.81), the engine's
            config 3 at 19.02 GB (1.83);
  * 'f16'   1.76: the F16 flagship at 9.51 GiB = 10.21 GB against 5.66
            GB (1.80), `benchmark_config(5)` without REMAT (batch 16) at
            7.13 GiB = 7.66 GB against 4.48 GB (1.71);
  * 'remat' 2.69: config 5 with REMAT at 3.32 GiB = 3.56 GB against
            1.33 GB (the structure keeps 0.15 of the activations; the
            eager checkpoints keep more).

An f32 step under REMAT was never measured: it borrows the 'remat'
factor, and `check_train_memory` says that its figure is uncalibrated.
It says the same of a ResNet-18/34 figure: every factor was fitted on
bottleneck backbones (ResNet-50/101), and a basic block keeps other
tensors for its backward (`chip_smoke.py` prints config 2's estimate
beside its measured peak, PERF.md); and of a step with batch-statistics
BN (TRAIN_BN None or True): every factor was fitted on frozen-BN steps,
and BN's training backward keeps its own tensors (`chip_smoke.py`
phase 8c prints the flagship's estimate beside its peak).
The factors were fitted on the peaks above, so those peaks can show only
drift; `chip_smoke.py` phase 4 also holds the flagship's step at half
its batch (16), which no factor was fitted on, to ±25% of its peak.

TRAIN_ACT_Q8 (True or 'wgrad8') is not in the structure or the factors:
`actq_saved_gb` adds, on top of the calibrated figure, the int8 copies
of the backbone convs' inputs that the step holds at once (the eager
step keeps the float inputs too, for the BN and ReLU backward) and,
under 'wgrad8', what the int8 weight-gradient route's layout adds to
those copies (q as KW column copies of padded rows,
`actq_cuda.wgrad_plan`). Without REMAT that is every conv's copy. Under
REMAT a residual block's checkpoint drops the copies of the convs inside
it and its recompute in the backward makes them again, one block at a
time: while block k's backward runs, the step holds the copies of the
convs outside every checkpoint that are still to be used (the stem's;
under 'narrow' also the 2a and 2b of blocks up to k) and block k's
recomputed copies; the estimate takes the most of that over the blocks.
`chip_smoke.py` phase 8g prints it beside each recipe's measured peak.

`check_train_memory` warns when the calibrated figure passes 60% of the
card's memory (`torch.cuda.get_device_properties(dev).total_memory`);
on the CPU there is no device memory to compare with.
"""

from __future__ import annotations

import math

import torch


def _backbone_act_elems(architecture: str, h: int, w: int) -> float:
    """Per-image saved-activation element count for the backbone fwd."""
    e = 0.0
    h, w = h / 2, w / 2              # stem /2
    e += h * w * 64                  # stem relu
    h, w = h / 2, w / 2              # maxpool /2
    if architecture in ('resnet50', 'resnet101'):
        widths = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
        reps = [3, 4, 6, 3] if architecture == 'resnet50' \
            else [3, 4, 23, 3]
        for (f1, f3), n in zip(widths, reps):
            for b in range(n):
                # 2 narrow relus + 1 wide block output per bottleneck
                e += h * w * (2 * f1 + f3)
            if f3 != 2048:
                h, w = h / 2, w / 2
    else:
        reps = [2, 2, 2, 2] if architecture == 'resnet18' else [3, 4, 6, 3]
        for stage, n in enumerate(reps):
            f = 64 * (2 ** stage)
            for b in range(n):
                e += h * w * 2 * f   # conv1 relu + block output
            if stage < 3:
                h, w = h / 2, w / 2
    return e


def _param_count(architecture: str, config) -> float:
    counts = {'resnet18': 11.2e6, 'resnet34': 21.3e6,
              'resnet50': 23.5e6, 'resnet101': 42.5e6}
    p = counts.get(architecture, 25e6)
    # bottleneck + heads (dense over flattened C6)
    h, w = config.IMAGE_SHAPE[0] / 64, config.IMAGE_SHAPE[1] / 64
    feats = h * w * config.BOTTLENECK_WIDTH
    c5 = 512 if architecture in ('resnet18', 'resnet34') else 2048
    p += 9 * c5 * config.BOTTLENECK_WIDTH
    n_heads = 1 if config.REGRESS_KEYPOINTS else 2
    if config.NR_DENSE_LAYERS > 0:
        # first hidden dense consumes feats; the rest are BRANCH_SIZE²
        p += n_heads * (feats * config.BRANCH_SIZE
                        + (config.NR_DENSE_LAYERS - 1)
                        * config.BRANCH_SIZE ** 2)
        fin_in = config.BRANCH_SIZE
    else:
        fin_in = feats
    # Final denses: the classification finals (bins³ outputs) dominate
    # wide configs — e.g. speed 64³ is fin_in × 262144.
    if config.REGRESS_KEYPOINTS:
        p += fin_in * 9
    else:
        loc_out = 3 if config.REGRESS_LOC else config.LOC_BINS_PER_DIM ** 3
        ori_out = (4 if config.ORIENTATION_PARAM == 'quaternion' else 3) \
            if config.REGRESS_ORI else config.ORI_BINS_PER_DIM ** 3
        p += fin_in * (loc_out + ori_out)
    return p


def _components_bytes(config):
    """(activation, param-state, batch) byte totals for one train step
    over the GLOBAL batch."""
    h, w = float(config.IMAGE_SHAPE[0]), float(config.IMAGE_SHAPE[1])
    batch = float(config.BATCH_SIZE)
    act_bytes = 2.0 if getattr(config, 'F16', False) else 4.0
    acts = _backbone_act_elems(config.BACKBONE, h, w) * batch * act_bytes
    if getattr(config, 'REMAT', False):
        acts *= 0.15                 # only block boundaries survive
    params = _param_count(config.BACKBONE, config)
    # f32 params + grads + 1-2 optimizer slots + bf16 compute copy
    param_bytes = params * 4 * (3.5 if config.OPTIMIZER != 'SGD' else 2.5)
    batch_bytes = batch * h * w * 3 * 4
    return acts, param_bytes, batch_bytes


def estimate_train_hbm_gb(config) -> float:
    """Rough peak device memory (GB) of one train step over the batch
    (the cotangent working set folded into a 1.25 factor)."""
    acts, param_bytes, batch_bytes = _components_bytes(config)
    return 1.25 * (acts + param_bytes + batch_bytes) / 1e9


# Measured peak / structural estimate of the eager step, per mode (the
# module's docstring gives the runs).
EAGER_FACTORS = {'f32': 1.82, 'f16': 1.76, 'remat': 2.69}


def eager_mode(config) -> str:
    """The key of `EAGER_FACTORS` for `config`: 'remat' under REMAT,
    else 'f16' under F16, else 'f32'."""
    if getattr(config, 'REMAT', False):
        return 'remat'
    return 'f16' if getattr(config, 'F16', False) else 'f32'


def calibrated_train_gb(config) -> float:
    """The structural estimate times the eager step's factor for the
    config's mode, plus TRAIN_ACT_Q8's saved copies (`actq_saved_gb`):
    the expected peak (GB) of one eager train step."""
    return EAGER_FACTORS[eager_mode(config)] * estimate_train_hbm_gb(config) \
        + actq_saved_gb(config)


def _ceil_half(v: int, s: int) -> int:
    return -(-v // s)


def backbone_blocks(config) -> list:
    """`backbone_convs` grouped as a train step runs them under REMAT:
    [stem], then one list a residual block, each entry (conv, part):
    part 'narrow' for a bottleneck's 2a and 2b (outside the checkpoint
    under REMAT='narrow'), 'expand' for its 2c and shortcut, 'block' for
    a basic block's convs (one checkpoint under every policy)."""
    from ursonet_torch.models.resnet import (SHALLOW_REPS, STAGE4_BLOCKS,
                                             scale_inner)
    n = int(config.BATCH_SIZE)
    h, w = int(config.IMAGE_SHAPE[0]), int(config.IMAGE_SHAPE[1])
    groups = [[((n, 3, h, w, 64, 7, 2, 3), 'stem')]]
    h, w = _ceil_half(_ceil_half(h, 2), 2), _ceil_half(_ceil_half(w, 2), 2)
    cin = 64
    arch = config.BACKBONE
    if arch in STAGE4_BLOCKS:
        mult = getattr(config, 'INNER_WIDTH_MULT', 1.0)
        reps = (3, 4, STAGE4_BLOCKS[arch] + 1, 3)
        for stage, (f, nb) in enumerate(zip((64, 128, 256, 512), reps)):
            f1, f3 = scale_inner(f, mult), 4 * f
            for b in range(nb):
                s = 2 if b == 0 and stage > 0 else 1
                ho, wo = _ceil_half(h, s), _ceil_half(w, s)
                block = [((n, cin, h, w, f1, 1, s, 0), 'narrow'),
                         ((n, f1, ho, wo, f1, 3, 1, 1), 'narrow'),
                         ((n, f1, ho, wo, f3, 1, 1, 0), 'expand')]
                if b == 0:          # the shortcut runs after the branch
                    block.append(((n, cin, h, w, f3, 1, s, 0), 'expand'))
                groups.append(block)
                h, w, cin = ho, wo, f3
        return groups
    for stage, nb in enumerate(SHALLOW_REPS[arch]):
        f = 64 * 2 ** stage
        for b in range(nb):
            s = 2 if b == 0 and stage > 0 else 1
            ho, wo = _ceil_half(h, s), _ceil_half(w, s)
            block = [((n, cin, h, w, f, 1, s, 0), 'block')] if b == 0 else []
            block += [((n, cin, h, w, f, 3, s, 1), 'block'),
                      ((n, f, ho, wo, f, 3, 1, 1), 'block')]
            groups.append(block)
            h, w, cin = ho, wo, f
    return groups


def recomputed(part, remat) -> bool:
    """Whether a backbone conv of `part` (`backbone_blocks`) runs inside
    a checkpoint under the REMAT policy `remat`, so that the backward
    recomputes it: every block's convs under True, 'all' and 'dots', a
    bottleneck's 2c and shortcut alone under 'narrow', the stem never."""
    if not remat or part == 'stem':
        return False
    return not (remat == 'narrow' and part == 'narrow')


def backbone_convs(config) -> list:
    """(N, Ci, H, W, Co, k, stride, pad) of every backbone conv of a train
    step, in the model's order (`models/resnet.py`), N the global batch:
    the convs that TRAIN_ACT_Q8 quantizes the input of, one 'x' call
    each. The s2d stem reads the image's elements as the 7x7/2 stem does
    and is counted as it."""
    return [conv for group in backbone_blocks(config) for conv, _ in group]


def _q_bytes(conv, mode) -> int:
    """Bytes of the int8 copy that a ConvQ8 saves of its input: plain, or
    under 'wgrad8' on the int8 route (N * Ho * Wo within the int32 guard)
    the layout its weight-gradient kernel reads."""
    from ursonet_torch.ops import actq_cuda
    n, ci, h, w, co, k, s, p = conv
    plain = n * ci * h * w
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    if mode != 'wgrad8' or n * ho * wo > actq_cuda.INT32_SAFE_ACC:
        return plain
    plan = actq_cuda.wgrad_plan((n, ci, h, w), co, (k, k), s,
                                ((p, p), (p, p)))
    return math.prod(plan.q_shape)


def actq_saved_gb(config) -> float:
    """What TRAIN_ACT_Q8 adds to a step's peak (GB): the int8 copies of
    the backbone convs' inputs that the step holds at once, one byte an
    element, under 'wgrad8' in the layout of the int8 route's convs
    (`_q_bytes`). Without REMAT every conv's; under REMAT, at the most
    over the blocks' backwards, the copies of the convs outside the
    checkpoints still alive (the stem's; under 'narrow' each bottleneck's
    2a and 2b up to that block) beside the block's recomputed copies (the
    module docstring). 0 without TRAIN_ACT_Q8."""
    mode = getattr(config, 'TRAIN_ACT_Q8', False)
    if not mode:
        return 0.0
    remat = getattr(config, 'REMAT', False)
    groups = backbone_blocks(config)
    if not remat:
        return sum(_q_bytes(c, mode) for g in groups for c, _ in g) / 1e9
    # the backward of block k runs while the kept copies of the stem and
    # of blocks 0..k are alive, beside block k's recomputed ones
    held, most = 0, 0
    for g in groups:
        held += sum(_q_bytes(c, mode) for c, part in g
                    if not recomputed(part, remat))
        most = max(most, held + sum(_q_bytes(c, mode) for c, part in g
                                    if recomputed(part, remat)))
    return most / 1e9


def calibration_gap(config):
    """Why no measured peak stands behind `config`'s factor, or None:
    an f32 step under REMAT, a backbone other than ResNet-50/101 (the
    structural count of ResNet-18/34 is a guess for HRNet), or
    batch-statistics BN."""
    if getattr(config, 'TRAIN_BN', False) is not False:
        return (f"the eager factors were fitted on frozen-BN steps "
                f"(TRAIN_BN=False), not on TRAIN_BN={config.TRAIN_BN!r}")
    if config.BACKBONE not in ('resnet50', 'resnet101'):
        return (f"the eager factors were fitted on ResNet-50/101 steps "
                f"only, not on a {config.BACKBONE} one")
    if getattr(config, 'REMAT', False) and not getattr(config, 'F16', False):
        return ("no f32 step under REMAT was measured, so it takes the F16 "
                "REMAT factor")
    return None


def calibrated(config) -> bool:
    """Whether a measured peak stands behind `config`'s factor: all modes
    of ResNet-50/101 with frozen BN but f32 under REMAT."""
    return calibration_gap(config) is None


def check_train_memory(config, device="cuda", log_fn=print) -> float:
    """Warn when the calibrated estimate passes 60% of the memory of
    `device` (a CUDA device; nothing to compare with on the CPU), and say
    so where the mode is not calibrated. Returns the calibrated estimate
    in GB."""
    est = calibrated_train_gb(config)
    gap = calibration_gap(config)
    if gap:
        log_fn(f"NOTE: the training memory estimate {est:.1f} GB is "
               f"uncalibrated: {gap}.")
    dev = torch.device(device)
    if dev.type == 'cuda':
        total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
        if est > 0.6 * total_gb:
            log_fn(f"WARNING: estimated training memory {est:.1f} GB "
                   f"against {total_gb:.1f} GB on "
                   f"{torch.cuda.get_device_name(dev)}; consider REMAT=True "
                   "or a smaller batch or image scale.")
    return est
