"""Decode of raw head outputs and the batched ESA score (the port of
`ursonet_tpu/evaluate.py::decode_results`, non-keypoint branch).

The orientation bin map is the port's `ops/encoders.build_ori_grid`
quaternions for config.ORI_BINS_PER_DIM (what the JAX package's datasets
carry as `ori_histogram_map`); a location classification head needs the
dataset's location bin map, passed in. Keypoint heads wait for a later
slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ursonet_torch.ops import decode as D
from ursonet_torch.ops.encoders import build_ori_grid


def ori_histogram_map(config) -> np.ndarray:
    """(bins³, 4) bin quaternions of config.ORI_BINS_PER_DIM."""
    return build_ori_grid(config.ORI_BINS_PER_DIM).quat


def decode_results(outputs, config, histogram_3d_map=None,
                   ori_map=None, power_iters: int = 50):
    """Batched decode of raw head outputs -> (loc_est [N,3], q_est [N,4])
    as float64 numpy arrays. Decodes on the outputs' device."""
    if config.REGRESS_KEYPOINTS:
        raise NotImplementedError(
            'keypoint decode (SVD alignment) is ported in a later slice')
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
