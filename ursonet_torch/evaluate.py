"""Decode of raw head outputs and the batched ESA score (the port of
`ursonet_tpu/evaluate.py::decode_results`).

The orientation bin map is the port's `ops/encoders.build_ori_grid`
quaternions for config.ORI_BINS_PER_DIM (what the JAX package's datasets
carry as `ori_histogram_map`); a location classification head needs the
dataset's location bin map, passed in. Keypoint heads decode by the
Kabsch/SVD alignment of the predicted keypoints with the model's
(`se3t.kabsch_rotation`, batched in float64).
"""

from __future__ import annotations

import numpy as np
import torch

from ursonet_torch import se3t
from ursonet_torch.data.loader import keypoint_scale
from ursonet_torch.ops import decode as D
from ursonet_torch.ops.encoders import build_ori_grid


def ori_histogram_map(config) -> np.ndarray:
    """(bins³, 4) bin quaternions of config.ORI_BINS_PER_DIM."""
    return build_ori_grid(config.ORI_BINS_PER_DIM).quat


def decode_keypoints(loc, k1, k2, scale: float):
    """Poses from predicted keypoints [N,3] each: the rotation that
    aligns the model's keypoints P1 = [s·e3, s·e2, 0] (columns) with the
    predicted [k1, k2, loc], transposed, as a quaternion; the location is
    `loc`. Float64 tensors on the inputs' device."""
    loc, k1, k2 = (D._t(v).to(torch.float64) for v in (loc, k1, k2))
    P1 = torch.zeros(3, 3, dtype=torch.float64, device=loc.device)
    P1[2, 0] = P1[1, 1] = scale
    R = se3t.kabsch_rotation(P1, torch.stack([k1, k2, loc], dim=-1))
    return loc, se3t.SO32quat(R.transpose(-1, -2))


def decode_results(outputs, config, histogram_3d_map=None,
                   ori_map=None, power_iters: int = 50,
                   dataset_name: str = 'Urso'):
    """Batched decode of raw head outputs -> (loc_est [N,3], q_est [N,4])
    as float64 numpy arrays. Decodes on the outputs' device.
    `dataset_name` sets the keypoint scale (`loader.keypoint_scale`)."""
    if config.REGRESS_KEYPOINTS:
        loc_est, q_est = decode_keypoints(
            outputs['loc'], outputs['k1'], outputs['k2'],
            keypoint_scale(dataset_name))
    else:
        if config.REGRESS_LOC:
            loc_est = D._t(outputs['loc']).to(torch.float64)
        else:
            if histogram_3d_map is None:
                raise ValueError('a location classification head needs the '
                                 "dataset's histogram_3d_map")
            loc_est = D.decode_loc_pmf(outputs['loc'], histogram_3d_map)
        if config.REGRESS_ORI:
            q_est = D.decode_ori_regression(outputs['ori'],
                                            config.ORIENTATION_PARAM)
        else:
            q_est = D.decode_ori_pmf(
                outputs['ori'],
                ori_histogram_map(config) if ori_map is None else ori_map,
                power_iters)
    return (loc_est.cpu().numpy().astype(np.float64),
            q_est.cpu().numpy().astype(np.float64))


def esa_scores(loc_est, q_est, loc_gt, q_gt) -> dict:
    """Per-image ESA score, location error (m) and orientation error
    (deg), and their means, batched on the inputs' device."""
    esa = D.esa_score(loc_est, loc_gt, q_est, q_gt)
    loc_err = D.location_error(loc_est, loc_gt)
    ori_err = D.angular_error_deg(q_est, q_gt)
    out = {'esa': esa, 'loc_err': loc_err, 'ori_err_deg': ori_err}
    out = {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}
    out.update({f'mean_{k}': float(np.mean(v)) for k, v in list(out.items())})
    return out
