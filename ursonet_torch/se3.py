"""SO(3) / quaternion / Euler-angle math on the host (numpy), the port's
own copy of the subset of `ursonet_tpu/se3.py` it needs.

Conventions as in the JAX package: quaternions are scalar-LAST
[qx, qy, qz, qw] in the JPL (left-handed) convention; Euler angles are
(pitch, yaw, roll) in DEGREES, left-handed XYZ order.
"""

from __future__ import annotations

import numpy as np

_DEG = np.pi / 180.0


def euler2SO3_left(pitch, yaw, roll):
    """Euler (deg) -> rotation matrix, left-handed XYZ order."""
    cp, sp = np.cos(pitch * _DEG), np.sin(pitch * _DEG)
    cy, sy = np.cos(yaw * _DEG), np.sin(yaw * _DEG)
    cr, sr = np.cos(roll * _DEG), np.sin(roll * _DEG)
    return np.array([
        [cy * cr, sp * sy * cr - cp * sr, cp * sy * cr + sp * sr],
        [cy * sr, sp * sy * sr + cp * cr, cp * sy * sr - sp * cr],
        [-sy, sp * cy, cp * cy],
    ])


def euler2quat(pitch, yaw, roll):
    """Euler (deg) -> scalar-last quaternion. Scalars or same-shape
    arrays; returns (..., 4)."""
    pitch = np.asarray(pitch, dtype=np.float64)
    half = _DEG / 2.0
    cp, sp = np.cos(pitch * half), np.sin(pitch * half)
    cy, sy = np.cos(np.asarray(yaw) * half), np.sin(np.asarray(yaw) * half)
    cr, sr = np.cos(np.asarray(roll) * half), np.sin(np.asarray(roll) * half)
    return np.stack([
        sy * sr * cp - cy * cr * sp,
        -sy * cr * cp - cy * sr * sp,
        -cy * sr * cp + sy * cr * sp,
        cy * cr * cp + sy * sr * sp,
    ], axis=-1)


def SO32quat(R):
    """Rotation matrix -> scalar-last JPL quaternion (Shepperd four-case
    selection in the reference's branch order)."""
    R = np.asarray(R, dtype=np.float64)
    q = np.zeros(4)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        Z = np.sqrt(tr + 1.0) * 2.0
        q[3] = 0.25 * Z
        q[0] = (R[1, 2] - R[2, 1]) / Z
        q[1] = (R[2, 0] - R[0, 2]) / Z
        q[2] = (R[0, 1] - R[1, 0]) / Z
    elif (R[0, 0] > R[1, 1]) and (R[0, 0] > R[2, 2]):
        Z = np.sqrt(1.0 + 2.0 * R[0, 0] - tr) * 2.0
        q[3] = (R[1, 2] - R[2, 1]) / Z
        q[0] = 0.25 * Z
        q[1] = (R[0, 1] + R[1, 0]) / Z
        q[2] = (R[0, 2] + R[2, 0]) / Z
    elif R[1, 1] > R[2, 2]:
        Z = np.sqrt(1.0 + 2.0 * R[1, 1] - tr) * 2.0
        q[3] = (R[2, 0] - R[0, 2]) / Z
        q[0] = (R[0, 1] + R[1, 0]) / Z
        q[1] = 0.25 * Z
        q[2] = (R[1, 2] + R[2, 1]) / Z
    else:
        Z = np.sqrt(1.0 + 2.0 * R[2, 2] - tr) * 2.0
        q[3] = (R[0, 1] - R[1, 0]) / Z
        q[0] = (R[0, 2] + R[2, 0]) / Z
        q[1] = (R[1, 2] + R[2, 1]) / Z
        q[2] = 0.25 * Z
    return q


def quat_mult(a, b):
    """Quaternion product (JPL composition), renormalised to unit length."""
    a = np.asarray(a, dtype=np.float64).reshape(4)
    b = np.asarray(b, dtype=np.float64).reshape(4)
    c = np.array([
        a[3] * b[0] + a[2] * b[1] - a[1] * b[2] + a[0] * b[3],
        -a[2] * b[0] + a[3] * b[1] + a[0] * b[2] + a[1] * b[3],
        a[1] * b[0] - a[0] * b[1] + a[3] * b[2] + a[2] * b[3],
        -a[0] * b[0] - a[1] * b[1] - a[2] * b[2] + a[3] * b[3],
    ])
    return c / np.linalg.norm(c)


def quat2SO3(q):
    """Scalar-last JPL quaternion -> rotation matrix."""
    x, y, z, w = np.asarray(q, dtype=np.float64).reshape(4)
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * (x * y + z * w), 2 * (x * z - y * w)],
        [2 * (x * y - z * w), 1 - 2 * x * x - 2 * z * z, 2 * (y * z + x * w)],
        [2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * x * x - 2 * y * y],
    ])


def quat2angleaxis(q):
    """Quaternion -> (axis, angle in radians)."""
    q = np.asarray(q, dtype=np.float64).reshape(4)
    theta = 2.0 * np.arccos(np.clip(q[3], -1.0, 1.0))
    if abs(q[3]) >= 1.0:
        return np.array([0.0, 0.0, 1.0]), theta
    return q[:3] / np.sin(theta / 2.0), theta


def quat2euler(q):
    """Scalar-last quaternion -> Euler (pitch, yaw, roll) in degrees,
    with the reference's pole-singularity handling."""
    x, y, z, w = np.asarray(q, dtype=np.float64).reshape(4)
    sqx, sqy, sqz = x * x, y * y, z * z
    test = x * z + y * w
    if test > 0.499:  # north-pole singularity
        pitch, yaw, roll = 2.0 * np.arctan2(x, w), -np.pi / 2, 0.0
    elif test < -0.499:  # south-pole singularity
        pitch, yaw, roll = -2.0 * np.arctan2(x, w), np.pi / 2, 0.0
    else:
        pitch = np.arctan2(2 * (y * z - x * w), 1 - 2 * sqx - 2 * sqy)
        yaw = np.arcsin(np.clip(-2 * (x * z + y * w), -1.0, 1.0))
        roll = np.arctan2(2 * (x * y - z * w), 1 - 2 * sqy - 2 * sqz)
    if pitch > np.pi:
        pitch = 2 * np.pi - pitch
    if pitch < -np.pi:
        pitch = 2 * np.pi + pitch
    return pitch / _DEG, yaw / _DEG, roll / _DEG


def quat_weighted_avg(Q, W):
    """Weighted quaternion average (Markley et al. 2007): the eigenvector
    of the largest eigenvalue of A = sum_i w_i q_i q_i^T, unit length,
    and A^-1 (a pseudo-inverse: A is rank-deficient when the weights
    sit on one quaternion) as the uncertainty."""
    Q = np.asarray(Q, dtype=np.float64)
    W = np.asarray(W, dtype=np.float64).reshape(-1)
    A = (Q * W[:, None]).T @ Q
    _, v = np.linalg.eigh(A)
    q_avg = v[:, -1]
    q_avg = q_avg / np.linalg.norm(q_avg)
    return q_avg, np.linalg.pinv(A)
