"""Batched, branchless tensor versions of the SE(3) math: the counterpart
of `ursonet_tpu/se3jax.py` for the subset the training step and the
pose decode need, and the batched rotation of `ursonet_tpu/se3.py`'s
`pose_3Dto3D` (`kabsch_rotation`).

Same conventions as `ursonet_torch.se3`. Every function takes tensors with
arbitrary leading batch dimensions; the Shepperd case selection runs as
`torch.where`, so nothing synchronises with the host.
"""

from __future__ import annotations

import math

import torch

_DEG = math.pi / 180.0


def euler2SO3_left(pitch, yaw, roll):
    """Euler (deg) -> rotation matrix, left-handed XYZ order. (..., 3, 3)."""
    cp, sp = torch.cos(pitch * _DEG), torch.sin(pitch * _DEG)
    cy, sy = torch.cos(yaw * _DEG), torch.sin(yaw * _DEG)
    cr, sr = torch.cos(roll * _DEG), torch.sin(roll * _DEG)
    rows = [
        torch.stack([cy * cr, sp * sy * cr - cp * sr, cp * sy * cr + sp * sr], -1),
        torch.stack([cy * sr, sp * sy * sr + cp * cr, cp * sy * sr - sp * cr], -1),
        torch.stack([-sy, sp * cy, cp * cy], -1),
    ]
    return torch.stack(rows, dim=-2)


def SO32quat(R):
    """Rotation matrix -> scalar-last JPL quaternion. (..., 3, 3) -> (..., 4)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    def pack(q0, q1, q2, q3):
        return torch.stack([q0, q1, q2, q3], dim=-1)

    def z_of(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    Zw = z_of(tr + 1.0)
    qw = pack((r12 - r21) / Zw, (r20 - r02) / Zw, (r01 - r10) / Zw, 0.25 * Zw)
    Zx = z_of(1.0 + 2.0 * r00 - tr)
    qx = pack(0.25 * Zx, (r01 + r10) / Zx, (r02 + r20) / Zx, (r12 - r21) / Zx)
    Zy = z_of(1.0 + 2.0 * r11 - tr)
    qy = pack((r01 + r10) / Zy, 0.25 * Zy, (r12 + r21) / Zy, (r20 - r02) / Zy)
    Zz = z_of(1.0 + 2.0 * r22 - tr)
    qz = pack((r02 + r20) / Zz, (r12 + r21) / Zz, 0.25 * Zz, (r01 - r10) / Zz)

    cond_w = (tr > 0)[..., None]
    cond_x = ((r00 > r11) & (r00 > r22))[..., None]
    cond_y = (r11 > r22)[..., None]
    return torch.where(cond_w, qw,
                       torch.where(cond_x, qx, torch.where(cond_y, qy, qz)))


def quat2SO3(q):
    """Scalar-last quaternion -> rotation matrix. (..., 4) -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * y * y - 2 * z * z, 2 * (x * y + z * w),
                     2 * (x * z - y * w)], -1),
        torch.stack([2 * (x * y - z * w), 1 - 2 * x * x - 2 * z * z,
                     2 * (y * z + x * w)], -1),
        torch.stack([2 * (x * z + y * w), 2 * (y * z - x * w),
                     1 - 2 * x * x - 2 * y * y], -1),
    ]
    return torch.stack(rows, dim=-2)


def quat_mult(a, b):
    """Quaternion product with renormalisation, batched."""
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    b0, b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    c = torch.stack([
        a3 * b0 + a2 * b1 - a1 * b2 + a0 * b3,
        -a2 * b0 + a3 * b1 + a0 * b2 + a1 * b3,
        a1 * b0 - a0 * b1 + a3 * b2 + a2 * b3,
        -a0 * b0 - a1 * b1 - a2 * b2 + a3 * b3,
    ], dim=-1)
    return c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)


def quat_inv(q):
    """Conjugate of a unit quaternion, batched."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def quat2euler(q):
    """Scalar-last quaternion -> Euler (pitch, yaw, roll) degrees, batched
    and branchless (the pole cases by torch.where)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sqx, sqy, sqz = x * x, y * y, z * z
    test = x * z + y * w

    pitch_n = torch.atan2(2 * (y * z - x * w), 1 - 2 * sqx - 2 * sqy)
    yaw_n = torch.asin(torch.clamp(-2 * (x * z + y * w), -1.0, 1.0))
    roll_n = torch.atan2(2 * (x * y - z * w), 1 - 2 * sqy - 2 * sqz)

    pitch_pole = 2.0 * torch.atan2(x, w)
    north = test > 0.499
    south = test < -0.499
    pole = north | south

    half_pi = torch.full_like(yaw_n, math.pi / 2)
    pitch = torch.where(pole, torch.where(north, pitch_pole, -pitch_pole),
                        pitch_n)
    yaw = torch.where(pole, torch.where(north, -half_pi, half_pi), yaw_n)
    roll = torch.where(pole, torch.zeros_like(roll_n), roll_n)

    pitch = torch.where(pitch > math.pi, 2 * math.pi - pitch, pitch)
    pitch = torch.where(pitch < -math.pi, 2 * math.pi + pitch, pitch)
    return torch.stack([pitch / _DEG, yaw / _DEG, roll / _DEG], dim=-1)


def angle_between_quats(q1, q2):
    """Angular distance in degrees along the last axis, batched."""
    dots = torch.sum(q1 * q2, dim=-1)
    return 2.0 * torch.arccos(torch.clamp(torch.abs(dots), 0.0, 1.0)) / _DEG


def _accumulator(Q, W):
    """A = Σ_n w_n q_n q_nᵀ: Q (..., n, 4) or a shared (n, 4), W (..., n)."""
    return torch.einsum('...ni,...n,...nj->...ij', Q, W, Q) if Q.dim() > 2 \
        else torch.einsum('ni,...n,nj->...ij', Q, W, Q)


def quat_weighted_avg(Q, W):
    """Weighted quaternion average by eigendecomposition of the 4x4
    accumulator, batched. Q: (..., n, 4) or (n, 4), W: (..., n) ->
    (q_avg (..., 4), A (..., 4, 4)). The eigenvector's sign is the
    solver's; q and -q are the same rotation."""
    A = _accumulator(Q, W)
    _, v = torch.linalg.eigh(A)
    q_avg = v[..., :, -1]
    q_avg = q_avg / torch.linalg.vector_norm(q_avg, dim=-1, keepdim=True)
    return q_avg, A


def quat_weighted_avg_power(Q, W, iters: int = 30):
    """Weighted quaternion average by power iteration on the (PSD, for a
    PMF) accumulator from a vector of ones: the dominant eigenvector, as
    quat_weighted_avg, without a 4x4 eigendecomposition per sample.
    Q: (..., n, 4) or (n, 4), W: (..., n) -> (..., 4)."""
    A = _accumulator(Q, W)
    v = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        v = torch.einsum('...ij,...j->...i', A, v)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v


def kabsch_rotation(P1, P2):
    """The rotation of the JAX package's `se3.pose_3Dto3D(P1, P2)` (its
    centroid branch, the one the keypoint decode takes) for a batch: P1 (3, N) or (..., 3, N), P2 (..., 3, N) of corresponding
    points as columns -> R (..., 3, 3), with the reflection fix
    diag(1, 1, det(U)·det(V))."""
    C1 = P1.mean(dim=-1, keepdim=True)
    C2 = P2.mean(dim=-1, keepdim=True)
    H = (P1 - C1) @ (P2 - C2).transpose(-1, -2)
    U, _, Vh = torch.linalg.svd(H)
    d = torch.linalg.det(U) * torch.linalg.det(Vh)
    U = torch.cat([U[..., :2], U[..., 2:] * d[..., None, None]], dim=-1)
    return U @ Vh
