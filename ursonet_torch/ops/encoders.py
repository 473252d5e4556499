"""Orientation and location soft-assignment encoders, the counterpart
of `ursonet_tpu/ops/encoders.py` (`build_ori_grid`, `ori_variance`,
`encode_ori_pmf`, `encode_ori`, `build_loc_grid`,
`encode_loc_pmf`, `encode_loc`).

SO(3) is quantized as an ORI_BINS_PER_DIM³ Euler-angle grid over
[-180,180]×[-90,90]×[-180,180]; each bin holds its quaternion; bins that
alias another orientation (boundary wrap, gimbal singularities) are
masked out; a quaternion becomes a Gaussian-kernel PMF over the remaining
bins with variance (BETA/nr_bins)²/12. The grid is built on the host;
`encode_ori_pmf` runs on numpy arrays or on tensors (on the device inside
the training step's preprocess). The location grid is the same Euler
product over (image_x, image_y, Z), back-projected to XYZ; the dataset
adapters encode on the host with numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ursonet_torch import se3


class OriGrid(NamedTuple):
    """quat: (bins³, 4) f32 quaternion of each bin; mask: (bins³,) True
    for redundant bins; euler: (bins³, 3) Euler angles of each bin."""
    quat: np.ndarray
    mask: np.ndarray
    euler: np.ndarray
    nr_bins_per_dim: int


def _euler_grid(nr_bins_per_dim: int, min_lim, max_lim) -> np.ndarray:
    """The bins³×3 Euler grid, last dimension fastest."""
    lin = np.linspace(0.0, 1.0, nr_bins_per_dim)
    g0, g1, g2 = np.meshgrid(lin, lin, lin, indexing='ij')
    grid = np.stack([g0.ravel(), g1.ravel(), g2.ravel()], axis=1)
    min_lim = np.asarray(min_lim, dtype=np.float64)
    max_lim = np.asarray(max_lim, dtype=np.float64)
    return grid * (max_lim - min_lim) + min_lim


def build_ori_grid(nr_bins_per_dim: int,
                   min_lim=(-180, -90, -180),
                   max_lim=(180, 90, 180)) -> OriGrid:
    """Grid, per-bin quaternions and the redundancy mask."""
    H_ori = _euler_grid(nr_bins_per_dim, min_lim, max_lim)
    H_quat = np.asarray(
        se3.euler2quat(H_ori[:, 0], H_ori[:, 1], H_ori[:, 2]),
        dtype=np.float32)
    min_lim = np.asarray(min_lim, dtype=np.float64)
    max_lim = np.asarray(max_lim, dtype=np.float64)
    # pitch == +180 or roll == +180 wrap onto the -180 bins
    boundary = np.logical_or(H_ori[:, 0] == max_lim[0],
                             H_ori[:, 2] == max_lim[2])
    # at yaw == ±90 every pitch but the first aliases the same orientation
    gimbal = np.logical_and(np.abs(H_ori[:, 1]) == max_lim[1],
                            H_ori[:, 0] != min_lim[0])
    mask = np.logical_or(boundary, gimbal)
    return OriGrid(quat=H_quat, mask=mask, euler=H_ori,
                   nr_bins_per_dim=nr_bins_per_dim)


def ori_variance(beta: float, nr_bins_per_dim: int) -> float:
    """Kernel variance: Gaussian approximation of a uniform bin."""
    delta = beta / nr_bins_per_dim
    return delta ** 2 / 12.0


def encode_ori_pmf(oris, grid_quat, grid_mask, beta, nr_bins_per_dim):
    """Encode quaternions as Gaussian-kernel PMFs over the bin grid.

    oris (..., 4), grid_quat (N, 4), grid_mask (N,) bool: all numpy
    arrays, or all tensors on one device. Returns (..., N) normalized
    PMFs of the same kind.
    """
    var = ori_variance(beta, nr_bins_per_dim)
    if isinstance(oris, torch.Tensor):
        dots = torch.abs(oris @ grid_quat.T)
        ang = torch.arccos(torch.clamp(dots, max=1.0)) / np.pi
        H = torch.exp(-2.0 * ang ** 2 / var)
        H = torch.where(grid_mask, torch.zeros_like(H), H)
        return H / torch.sum(H, dim=-1, keepdim=True)
    dots = np.abs(oris @ grid_quat.T)
    ang = np.arccos(np.minimum(dots, 1.0)) / np.pi
    H = np.exp(-2.0 * ang ** 2 / var)
    H = np.where(grid_mask, np.zeros_like(H), H)
    return H / np.sum(H, axis=-1, keepdims=True)


def encode_ori(oris, nr_bins_per_dim, beta, min_lim, max_lim):
    """The dataset adapters' orientation encoding: returns (encoded PMFs
    float32, bin quaternions, redundant-bin mask)."""
    oris = np.asarray(oris, dtype=np.float32)
    grid = build_ori_grid(nr_bins_per_dim, min_lim, max_lim)
    encoded = encode_ori_pmf(oris, grid.quat, grid.mask, beta,
                             nr_bins_per_dim).astype(np.float32)
    return encoded, grid.quat, grid.mask


class LocGrid(NamedTuple):
    """map3d: (bins³, 3) physical XYZ of each bin: the Euler-product grid
    over (image_x, image_y, Z) with the first two multiplied by Z;
    var: the isotropic Gaussian variance of the encoding."""
    map3d: np.ndarray
    nr_bins_per_dim: int
    var: float


def build_loc_grid(nr_bins_per_dim: int, beta: float, min_lim,
                   max_lim) -> LocGrid:
    """The location histogram structure; the bin width is
    beta / nr_bins_per_dim, as the reference sets it."""
    H = _euler_grid(nr_bins_per_dim, min_lim, max_lim)
    H[:, 0] = H[:, 0] * H[:, 2]
    H[:, 1] = H[:, 1] * H[:, 2]
    delta = beta / nr_bins_per_dim
    return LocGrid(map3d=H.astype(np.float32),
                   nr_bins_per_dim=nr_bins_per_dim, var=delta ** 2 / 12.0)


def encode_loc_pmf(locs, grid_map3d, var):
    """(..., 3) locations as (image_x, image_y, Z) -> (..., bins³)
    Gaussian PMFs over the XYZ bin grid (the normal's constant cancels
    in the normalization)."""
    Z = locs[..., 2:3]
    xyz = np.concatenate([locs[..., 0:1] * Z, locs[..., 1:2] * Z, Z],
                         axis=-1)
    d2 = np.sum((xyz[..., None, :] - grid_map3d) ** 2, axis=-1)
    H = np.exp(-0.5 * d2 / var)
    return H / np.sum(H, axis=-1, keepdims=True)


def encode_loc(locs, nr_bins_per_dim, beta, min_lim, max_lim):
    """The dataset adapters' location encoding, in float64: returns
    (encoded PMFs float32, bin map3d)."""
    locs = np.asarray(locs, dtype=np.float64)
    grid = build_loc_grid(nr_bins_per_dim, beta, min_lim, max_lim)
    encoded = encode_loc_pmf(locs, grid.map3d.astype(np.float64), grid.var)
    return encoded.astype(np.float32), grid.map3d
