"""Pose decoding: network head outputs -> (location, quaternion), the port
of `ursonet_tpu/ops/decode.py`.

  * classification heads: stable softmax over the bins, then
    - location    = the PMF's first moment over the bin XYZ map
    - orientation = the weighted quaternion average over the bin
      quaternion map, by power iteration on the 4x4 accumulator (50
      iterations by default) or by eigh.
  * regression heads: quaternion passthrough (renormalized), euler ->
    SO3 -> quaternion, angle-axis norm/axis split.

Batched tensor ops on the tensors' device; numpy inputs become tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ursonet_torch import se3t


def _t(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    a = np.asarray(x)
    return torch.as_tensor(a if a.flags.writeable else a.copy(),
                           device=device)


def stable_softmax(x, dim=-1):
    """Numerically stable softmax, batched."""
    x = _t(x)
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def decode_loc_pmf(loc_logits, histogram_3d_map):
    """Location from a classification head: the softmax's first moment.
    loc_logits [B, bins³] -> [B, 3]."""
    pmf = stable_softmax(_t(loc_logits).to(torch.float32))
    return pmf @ _t(histogram_3d_map, pmf.device).to(torch.float32)


def decode_loc_encoded(pmf, histogram_3d_map):
    """First moment of an already normalized PMF."""
    pmf = _t(pmf).to(torch.float32)
    return pmf @ _t(histogram_3d_map, pmf.device).to(torch.float32)


def decode_ori_pmf(ori_logits, ori_histogram_map, power_iters: int = 50,
                   use_eigh: bool = False):
    """Orientation from a classification head: softmax, then the weighted
    quaternion average over the bin map. [B, bins³] -> unit [B, 4]."""
    pmf = stable_softmax(_t(ori_logits).to(torch.float32))
    return decode_ori_encoded(pmf, ori_histogram_map, power_iters, use_eigh)


def decode_ori_encoded(pmf, ori_histogram_map, power_iters: int = 50,
                       use_eigh: bool = False):
    """Weighted quaternion average of a normalized PMF [..., bins³]."""
    pmf = _t(pmf).to(torch.float32)
    Q = _t(ori_histogram_map, pmf.device).to(torch.float32)
    if use_eigh:
        q, _ = se3t.quat_weighted_avg(Q, pmf)
        return q
    return se3t.quat_weighted_avg_power(Q, pmf, iters=power_iters)


def decode_ori_regression(ori_out, orientation_param: str):
    """Orientation from a regression head. ori_out [B, 4] (quaternion)
    or [B, 3] (euler_angles / angle_axis)."""
    ori_out = _t(ori_out).to(torch.float32)
    if orientation_param == 'quaternion':
        return ori_out / torch.linalg.vector_norm(ori_out, dim=-1,
                                                  keepdim=True)
    if orientation_param == 'euler_angles':
        R = se3t.euler2SO3_left(ori_out[..., 0], ori_out[..., 1],
                                ori_out[..., 2])
        return se3t.SO32quat(R)
    if orientation_param == 'angle_axis':
        theta = torch.linalg.vector_norm(ori_out, dim=-1, keepdim=True)
        v = torch.where(theta < 1e-6, torch.zeros_like(ori_out),
                        ori_out / theta)
        s = torch.sin(theta / 2.0)
        return torch.cat([v * s, torch.cos(theta / 2.0)], dim=-1)
    raise ValueError(f"unknown orientation param {orientation_param}")


# ---------------------------------------------------------------------------
# Error metrics (batched)
# ---------------------------------------------------------------------------

def angular_error_deg(q_est, q_gt):
    """2·arccos|⟨q,q̂⟩| in degrees."""
    d = torch.abs(torch.sum(_t(q_est) * _t(q_gt), dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, 0.0, 1.0)) * 180.0 / math.pi


def location_error(loc_est, loc_gt):
    """L2 location error."""
    return torch.linalg.vector_norm(_t(loc_est) - _t(loc_gt), dim=-1)


def esa_score(loc_est, loc_gt, q_est, q_gt):
    """ESA challenge score: ‖t−t̂‖/‖t‖ + 2·arccos|⟨q,q̂⟩| in radians."""
    loc_gt = _t(loc_gt)
    rel = location_error(loc_est, loc_gt) / torch.linalg.vector_norm(
        loc_gt, dim=-1)
    ang = torch.abs(torch.sum(_t(q_est) * _t(q_gt), dim=-1))
    return rel + 2.0 * torch.arccos(torch.clamp(ang, 0.0, 1.0))
