"""Loss functions, the counterpart of `ursonet_tpu/train/losses.py`,
with the reference's quirks kept:

  * softmax_loss: softmax cross-entropy against soft PMF targets, applied
    to the head's ReLU-activated outputs used as logits.
  * one_minus_dot_loss: 1 − |⟨q, q̂⟩| for quaternion regression.
  * rel_loss: ‖Y−Ŷ‖_F / ‖Y‖_F over the whole [B,3] batch tensor, not per
    row.
  * keypoint mode: mean squared error of the three keypoints, named
    'loc_loss', 'k2_loss' and 'k3_loss' (against gt_loc, gt_k1, gt_k2).
  * l2_regularization: WEIGHT_DECAY · mean(w²) per tensor, summed over
    the trainable parameters that are not batch norm.

All losses compute in float32 (under F16 on the head outputs the model
has widened to f32, as the JAX step takes them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ursonet_torch.models.resnet import FrozenBN


def softmax_loss(y_gt, y_pred):
    """Soft-target softmax cross-entropy, mean over the batch."""
    log_p = F.log_softmax(y_pred.float(), dim=-1)
    return torch.mean(-torch.sum(y_gt.float() * log_p, dim=-1))


def one_minus_dot_loss(y_true, y_pred):
    d = torch.sum(y_true.float() * y_pred.float(), dim=-1, keepdim=True)
    return torch.mean(1.0 - torch.abs(d))


def mse_loss(y_gt, y_pred):
    return torch.mean(torch.square(y_gt.float() - y_pred.float()))


def rel_loss(y_gt, y_pred):
    """Frobenius-relative location loss; norms over the entire batch."""
    y_gt = y_gt.float()
    return torch.linalg.vector_norm(
        (y_gt - y_pred.float()) / torch.linalg.vector_norm(y_gt))


def regularized_params(model, trainable=None):
    """(name, parameter) pairs the L2 term covers: every parameter outside
    batch norm whose `trainable` flag (name -> bool) is set."""
    for mod_name, mod in model.named_modules():
        if isinstance(mod, FrozenBN):
            continue
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            if trainable is None or trainable[name]:
                yield name, p


def l2_regularization(model, weight_decay: float, trainable=None):
    """Σ wd·mean(w²) over `regularized_params(model, trainable)`."""
    terms = [torch.mean(torch.square(p.float()))
             for _, p in regularized_params(model, trainable)]
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return weight_decay * torch.stack(terms).sum()


def compute_losses(outputs, batch, config):
    """Weighted total and the unweighted named parts for one batch."""
    if config.LEARNABLE_LOSS_WEIGHTS:
        raise NotImplementedError(
            "LEARNABLE_LOSS_WEIGHTS is ported in a later slice")
    parts = {}
    if config.REGRESS_KEYPOINTS:
        parts['loc_loss'] = mse_loss(batch['gt_loc'], outputs['loc'])
        parts['k2_loss'] = mse_loss(batch['gt_k1'], outputs['k1'])
        parts['k3_loss'] = mse_loss(batch['gt_k2'], outputs['k2'])
    else:
        if config.REGRESS_LOC:
            parts['loc_loss'] = rel_loss(batch['gt_loc'], outputs['loc'])
        else:
            parts['loc_loss'] = softmax_loss(batch['gt_loc'], outputs['loc'])
        if config.REGRESS_ORI:
            parts['ori_loss'] = one_minus_dot_loss(batch['gt_ori'],
                                                   outputs['ori'])
        else:
            parts['ori_loss'] = softmax_loss(batch['gt_ori'], outputs['ori'])
    total = sum(value * config.LOSS_WEIGHTS.get(name, 1.0)
                for name, value in parts.items())
    return total, parts
