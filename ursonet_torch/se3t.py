"""Batched, branchless tensor versions of the SE(3) math: the counterpart
of `ursonet_tpu/se3jax.py` for the subset the training step needs.

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
