"""Pre-flight estimate of a train step's device memory, the counterpart
of `ursonet_tpu/utils/memory.py` with the same structural estimate:

  * saved forward activations (every residual block's ReLU outputs kept
    for the backward), in the compute dtype (a 0.15 share of them under
    REMAT);
  * parameters, gradients and optimizer slots (f32);
  * the input batch.

It is a lower bound on what the step holds. `check_train_memory` warns
when it passes 60% of the card's memory
(`torch.cuda.get_device_properties(dev).total_memory`); on the CPU there
is no device memory to compare with.

The eager PyTorch step holds more than this structure counts: for
benchmark_config(3) at batch 32 on an H100 80GB HBM3 at 700 W
(chip_smoke.py's engine phase) the estimate is 10.41 GB and the measured peak
(`torch.cuda.max_memory_allocated`) 19.02 GB, 1.83 times as much. So the
warning fires only once the real step is near the card's memory; the
factor is not calibrated for the eager step (PERF.md §7).
"""

from __future__ import annotations

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


def check_train_memory(config, device="cuda", log_fn=print) -> float:
    """Warn when the estimate passes 60% of the memory of `device` (a
    CUDA device; nothing to compare with on the CPU). Returns the
    estimate in GB."""
    est = estimate_train_hbm_gb(config)
    dev = torch.device(device)
    if dev.type == 'cuda':
        total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
        if est > 0.6 * total_gb:
            log_fn(f"WARNING: estimated training memory >= {est:.1f} GB "
                   f"(lower bound) against {total_gb:.1f} GB on "
                   f"{torch.cuda.get_device_name(dev)}; consider REMAT=True "
                   "or a smaller batch or image scale.")
    return est
