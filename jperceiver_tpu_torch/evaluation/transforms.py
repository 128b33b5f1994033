"""Rotation representations: quaternion / matrix / Euler conversions.

The port's own copy of `jperceiver_tpu/evaluation/transforms.py` (numpy only; the port imports
nothing of the JAX package).

Covers the subset of the reference's vendored Gohlke transformations
(`mono/tools/transformations.py`) and evo lie-algebra helpers
(`mono/tools/lie_algebra.py`) that the trajectory tooling needs. Quaternion
order is (w, x, y, z).
"""

from __future__ import annotations

import numpy as np


def quaternion_matrix(q) -> np.ndarray:
    """(w, x, y, z) -> 4x4 homogeneous rotation."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(4)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    out = np.eye(4)
    out[:3, :3] = [
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ]
    return out


def quaternion_from_matrix(M) -> np.ndarray:
    """Rotation (>=3x3) -> (w, x, y, z), Shepperd's method."""
    R = np.asarray(M, np.float64)[:3, :3]
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def euler_from_matrix(M, order: str = "xyz") -> tuple[float, float, float]:
    """Rotation -> intrinsic Euler angles; 'xyz' (roll, pitch, yaw)."""
    R = np.asarray(M, np.float64)[:3, :3]
    if order != "xyz":
        raise NotImplementedError(order)
    sy = -R[2, 0]
    cy = np.sqrt(max(0.0, 1.0 - sy * sy))
    if cy > 1e-8:
        roll = np.arctan2(R[2, 1], R[2, 2])
        pitch = np.arcsin(np.clip(sy, -1, 1))
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-R[1, 2], R[1, 1])
        pitch = np.arcsin(np.clip(sy, -1, 1))
        yaw = 0.0
    return float(roll), float(pitch), float(yaw)


def euler_from_matrix_axes(M, axes: str = "sxyz") -> tuple[float, float, float]:
    """Euler angles in any of the 24 Shoemake conventions ('sxyz'..'rzyx').

    Same contract as Gohlke `transformations.euler_from_matrix` (the
    reference's vendored copy, used with axes='szxy' by the rpy plot,
    `kitti_evaluation_toolkit.py:243`); implemented from the standard
    Graphics Gems IV euler-factorization algorithm.
    """
    axes = axes.lower()
    frame = {"s": 0, "r": 1}[axes[0]]
    seq = axes[1:]
    if frame:  # rotating-frame 'rabc' == static 'scba' with swapped ends
        seq = seq[::-1]
    idx = {"x": 0, "y": 1, "z": 2}
    i, j = idx[seq[0]], idx[seq[1]]
    repetition = 1 if seq[0] == seq[2] else 0
    k = ({0, 1, 2} - {i, j}).pop() if repetition else idx[seq[2]]
    nxt = [1, 2, 0]
    parity = 0 if j == nxt[i] else 1

    R = np.asarray(M, np.float64)[:3, :3]
    eps = np.finfo(np.float64).eps * 4.0
    if repetition:
        sy = np.sqrt(R[i, j] * R[i, j] + R[i, k] * R[i, k])
        if sy > eps:
            ax = np.arctan2(R[i, j], R[i, k])
            ay = np.arctan2(sy, R[i, i])
            az = np.arctan2(R[j, i], -R[k, i])
        else:
            ax = np.arctan2(-R[j, k], R[j, j])
            ay = np.arctan2(sy, R[i, i])
            az = 0.0
    else:
        cy = np.sqrt(R[i, i] * R[i, i] + R[j, i] * R[j, i])
        if cy > eps:
            ax = np.arctan2(R[k, j], R[k, k])
            ay = np.arctan2(-R[k, i], cy)
            az = np.arctan2(R[j, i], R[i, i])
        else:
            ax = np.arctan2(-R[j, k], R[j, j])
            ay = np.arctan2(-R[k, i], cy)
            az = 0.0
    if parity:
        ax, ay, az = -ax, -ay, -az
    if frame:
        ax, az = az, ax
    return float(ax), float(ay), float(az)


def euler_matrix_axes(ai: float, aj: float, ak: float,
                      axes: str = "sxyz") -> np.ndarray:
    """Inverse of `euler_from_matrix_axes` (Gohlke `euler_matrix`)."""
    axes = axes.lower()
    frame = {"s": 0, "r": 1}[axes[0]]
    seq = axes[1:]
    if frame:  # rotating-frame 'rabc' == static 'scba' with swapped ends
        seq = seq[::-1]
    idx = {"x": 0, "y": 1, "z": 2}
    i, j = idx[seq[0]], idx[seq[1]]
    repetition = 1 if seq[0] == seq[2] else 0
    k = ({0, 1, 2} - {i, j}).pop() if repetition else idx[seq[2]]
    nxt = [1, 2, 0]
    parity = 0 if j == nxt[i] else 1

    if frame:
        ai, ak = ak, ai
    if parity:
        ai, aj, ak = -ai, -aj, -ak
    si, sj, sk = np.sin(ai), np.sin(aj), np.sin(ak)
    ci, cj, ck = np.cos(ai), np.cos(aj), np.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk

    R = np.eye(4)
    if repetition:
        R[i, i] = cj
        R[i, j] = sj * si
        R[i, k] = sj * ci
        R[j, i] = sj * sk
        R[j, j] = -cj * ss + cc
        R[j, k] = -cj * cs - sc
        R[k, i] = -sj * ck
        R[k, j] = cj * sc + cs
        R[k, k] = cj * cc - ss
    else:
        R[i, i] = cj * ck
        R[i, j] = sj * sc - cs
        R[i, k] = sj * cc + ss
        R[j, i] = cj * sk
        R[j, j] = sj * ss + cc
        R[j, k] = sj * cs - sc
        R[k, i] = -sj
        R[k, j] = cj * si
        R[k, k] = cj * ci
    return R


def euler_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Intrinsic xyz Euler -> 4x4 rotation."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    out = np.eye(4)
    out[:3, :3] = Rz @ Ry @ Rx
    return out


def so3_log(R) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (3,)."""
    R = np.asarray(R, np.float64)[:3, :3]
    cos_a = np.clip(0.5 * (np.trace(R) - 1.0), -1.0, 1.0)
    angle = np.arccos(cos_a)
    if angle < 1e-10:
        return np.zeros(3)
    if abs(angle - np.pi) < 1e-6:
        # near pi: extract axis from R + I
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0))
        axis = axis / np.linalg.norm(axis)
        return axis * angle
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v / (2.0 * np.sin(angle)) * angle


def se3_exp(omega: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Twist (rotation omega, translation v) -> 4x4 SE3 (Rodrigues + V)."""
    theta = np.linalg.norm(omega)
    out = np.eye(4)
    if theta < 1e-10:
        out[:3, 3] = v
        return out
    k = omega / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    V = (
        np.eye(3)
        + (1 - np.cos(theta)) / theta * K
        + (theta - np.sin(theta)) / theta * (K @ K)
    )
    out[:3, :3] = R
    out[:3, 3] = V @ v
    return out
