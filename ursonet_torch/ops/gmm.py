"""Multimodal orientation: EM fit of a quaternion Gaussian mixture to an
orientation PMF, the port's copy of `ursonet_tpu/ops/gmm.py` (numpy on
the host; the reference's experimental fit_GMM_to_orientation).

Modes are seeded at the strongest bins not within 3 sigma of an earlier
mode; the responsibilities come from angular Gaussians, the means are
PMF-weighted quaternion averages; the number of modes grows while the
PMF-weighted log-likelihood improves by more than 0.005.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ursonet_torch import se3


def _angles_norm(q_map: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Normalized angular distance in [0,1]: angle(q_i, q_k)/180.
    q_map [M,4], Q [N,4] -> [M,N]."""
    d = np.abs(q_map @ np.asarray(Q).T)
    return 2.0 * np.arccos(np.clip(d, -1.0, 1.0)) * (180.0 / np.pi) / 180.0


def fit_gmm_to_orientation(q_map, pmf, nr_iterations: int, var: float,
                           nr_max_modes: int = 4, verbose: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      list]:
    """Fit up to `nr_max_modes-1` quaternion Gaussians to a PMF with EM.

    Returns (means [N,4], variances [N], priors [N], scores), modes sorted
    by decreasing prior.
    """
    q_map = np.asarray(q_map, np.float64)
    pmf = np.asarray(pmf, np.float64).ravel()
    nr_total_bins = len(pmf)
    order = pmf.argsort()[::-1]
    scores: list = []
    best = None

    for N in range(1, nr_max_modes):
        # seed the means at the strongest bins not suppressed yet
        Q_mean = np.zeros((N, 4))
        Q_var = np.full(N, var)
        priors = np.full(N, 1.0 / N)
        suppressed = np.zeros(nr_total_bins, bool)  # in sorted order
        ptr = 0
        for k in range(N):
            while ptr < nr_total_bins and suppressed[ptr]:
                ptr += 1
            if ptr >= nr_total_bins:
                break
            q_max = q_map[order[ptr]]
            Q_mean[k] = q_max
            suppressed[ptr] = True
            # every bin within 3 sigma of this mode
            d2 = _angles_norm(q_map[order], q_max[None])[:, 0] ** 2
            suppressed |= d2 < 9.0 * var

        # EM
        p_X = np.full(nr_total_bins, 1e-18)
        for it in range(nr_iterations):
            # E-step: responsibilities from angular Gaussians
            D = _angles_norm(q_map, Q_mean)                    # [M,N]
            p_x_given = 1e-18 + np.exp(-D ** 2 / (2.0 * Q_var)) / \
                np.sqrt(2.0 * np.pi * Q_var)
            joint = p_x_given * priors
            p_X = joint.sum(axis=1)
            resp = joint / p_X[:, None]

            # M-step: PMF-weighted quaternion averages and variances
            W = resp * pmf[:, None]
            Z = W.sum(axis=0)
            W_n = W / np.maximum(Z, 1e-30)
            for k in range(N):
                q_mean_k, _ = se3.quat_weighted_avg(q_map, W_n[:, k])
                Q_mean[k] = np.ravel(q_mean_k)
                d2 = _angles_norm(q_map, Q_mean[k][None])[:, 0] ** 2
                Q_var[k] = float(W_n[:, k] @ d2)
            priors = Z

            if N == 1 and it == 1:
                break

        score = float(pmf @ np.log(p_X))
        if not scores or score > scores[-1] + 0.005:
            best = (Q_mean, Q_var, priors)
            scores.append(score)
        else:
            break

    Q_mean, Q_var, priors = best
    idx = priors.argsort()[::-1]
    Q_mean, Q_var, priors = Q_mean[idx], Q_var[idx], priors[idx]
    if verbose:
        print('Q priors:', priors)
        print('Q :', Q_mean)
        print('Scores:', scores)
    return Q_mean, Q_var, priors, scores
