"""Loss functions, the counterpart of `ursonet_tpu/train/losses.py`,
with the reference's quirks kept:

  * softmax_loss: softmax cross-entropy against soft PMF targets, applied
    to the head's ReLU-activated outputs used as logits.
  * one_minus_dot_loss: 1 − |⟨q, q̂⟩| for quaternion regression.
  * rel_loss: ‖Y−Ŷ‖_F / ‖Y‖_F over the whole [B,3] batch tensor, not per
    row.
  * keypoint mode: mean squared error of the three keypoints, named
    'loc_loss', 'k2_loss' and 'k3_loss' (against gt_loc, gt_k1, gt_k2).
  * landmark model (BACKBONE 'hrnet_w32'): HRNet's JointsMSELoss with
    target weights, ½ · mean over landmarks of the mean squared error of
    the weighted heatmaps, mean((w·(ŷ − y))²) / 2 over the batch, the
    landmarks and the pixels, named 'landmark_loss'.
  * l2_regularization: WEIGHT_DECAY · mean(w²) per tensor, summed over
    the trainable parameters that are not batch norm, nor the Kendall
    log-variances.
  * LEARNABLE_LOSS_WEIGHTS: learnable log-variances sₖ, one a loss part
    (the model's `loss_log_vars`, train/state.py), weight the total as
    Σ exp(−sₖ)·wₖ·Lₖ + sₖ.

All losses compute in float32 (under F16 on the head outputs the model
has widened to f32, as the JAX step takes them).

Over a mesh whose 'data' axis splits, `red` (`parallel/sharding.py::
DataReduce`) makes every loss the global batch's, as the JAX step
computes it over the sharded batch: each rank's partial sums are
all-reduced over 'data', so every rank holds the global value and the
gradient of its own rows (the step's all-reduce sums the parts). The L2
term of a tensor split over 'model' (`split`: its names) adds the
squares of all its shards and divides by the whole tensor's size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ursonet_torch.models.resnet import FrozenBN
from ursonet_torch.parallel.sharding import global_sum, scale_grad

LOG_VARS = 'loss_log_vars'


def log_vars_of(model):
    """The model's Kendall log-variances {loss name: 0-d parameter}, or
    None."""
    return getattr(model, LOG_VARS, None)


def _mean(x, red=None):
    """The mean of x's elements over the global batch."""
    if red is None:
        return torch.mean(x)
    return red.sum(x.sum()) / (x.numel() * red.size)


def _norm(x, red=None):
    """The Frobenius norm of x over the global batch."""
    if red is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(red.sum(torch.square(x).sum()))


def softmax_loss(y_gt, y_pred, red=None):
    """Soft-target softmax cross-entropy, mean over the batch."""
    log_p = F.log_softmax(y_pred.float(), dim=-1)
    return _mean(-torch.sum(y_gt.float() * log_p, dim=-1), red)


def one_minus_dot_loss(y_true, y_pred, red=None):
    d = torch.sum(y_true.float() * y_pred.float(), dim=-1, keepdim=True)
    return _mean(1.0 - torch.abs(d), red)


def mse_loss(y_gt, y_pred, red=None):
    return _mean(torch.square(y_gt.float() - y_pred.float()), red)


def joints_mse(heatmaps, target, weight, red=None):
    """HRNet's JointsMSELoss(use_target_weight=True): heatmaps, target
    [B,K,h,w], weight [B,K]."""
    w = weight.float()[..., None, None]
    return 0.5 * _mean(torch.square(w * (heatmaps.float() - target.float())),
                       red)


def rel_loss(y_gt, y_pred, red=None):
    """Frobenius-relative location loss; norms over the entire batch."""
    y_gt = y_gt.float()
    return _norm((y_gt - y_pred.float()) / _norm(y_gt, red), red)


def regularized_params(model, trainable=None):
    """(name, parameter) pairs the L2 term covers: every parameter outside
    batch norm whose `trainable` flag (name -> bool) is set."""
    for mod_name, mod in model.named_modules():
        if isinstance(mod, FrozenBN) or mod_name == LOG_VARS:
            continue
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if trainable is None or trainable[name]:
                yield name, p


def l2_regularization(model, weight_decay: float, trainable=None,
                      split=None, group=None):
    """Σ wd·mean(w²) over `regularized_params(model, trainable)`. `split`
    {name: (axis, whole length)}: tensors held as shards over the
    'model' group `group`, whose mean is the whole tensor's."""
    terms = []
    for name, p in regularized_params(model, trainable):
        if group is not None and name in (split or {}):
            whole = p.numel() // p.shape[split[name][0]] * split[name][1]
            terms.append(global_sum(torch.square(p.float()).sum(), group)
                         / whole)
        else:
            terms.append(torch.mean(torch.square(p.float())))
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return weight_decay * torch.stack(terms).sum()


def compute_losses(outputs, batch, config, log_vars=None, red=None):
    """Weighted total and the unweighted named parts for one batch.
    log_vars: {loss name: learnable log-variance s}, each part it names
    weighted as exp(−s)·w·L + s. red: the reduction over the global batch
    (None: this batch is the whole one); each data rank then computes
    the log-variances' whole gradient, so it is scaled by 1/D."""
    parts = {}
    if 'heatmaps' in outputs:
        if 'gt_heatmaps' not in batch:
            raise ValueError("the landmark model trains on the heatmap "
                             "targets the on-device preprocess renders "
                             "(AUGMENT_ON_DEVICE)")
        parts['landmark_loss'] = joints_mse(
            outputs['heatmaps'], batch['gt_heatmaps'], batch['gt_weights'],
            red)
    elif config.REGRESS_KEYPOINTS:
        parts['loc_loss'] = mse_loss(batch['gt_loc'], outputs['loc'], red)
        parts['k2_loss'] = mse_loss(batch['gt_k1'], outputs['k1'], red)
        parts['k3_loss'] = mse_loss(batch['gt_k2'], outputs['k2'], red)
    else:
        if config.REGRESS_LOC:
            parts['loc_loss'] = rel_loss(batch['gt_loc'], outputs['loc'],
                                         red)
        else:
            parts['loc_loss'] = softmax_loss(batch['gt_loc'], outputs['loc'],
                                             red)
        if config.REGRESS_ORI:
            parts['ori_loss'] = one_minus_dot_loss(batch['gt_ori'],
                                                   outputs['ori'], red)
        else:
            parts['ori_loss'] = softmax_loss(batch['gt_ori'], outputs['ori'],
                                             red)
    total = 0.0
    for name, value in parts.items():
        w = config.LOSS_WEIGHTS.get(name, 1.0)
        if log_vars is not None and name in log_vars:
            s = log_vars[name].float()
            if red is not None:
                s = scale_grad(s, 1.0 / red.size)
            total = total + torch.exp(-s) * w * value + s
        else:
            total = total + value * w
    return total, parts
