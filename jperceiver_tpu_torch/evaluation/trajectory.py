"""Trajectory math: pose-file IO, accumulation, Umeyama alignment.

The port's own copy of `jperceiver_tpu/evaluation/trajectory.py` (numpy only; the port imports
nothing of the JAX package).

Covers the slice of the vendored evo toolkit the reference actually uses
(`mono/tools/trajectory.py:367-434`, `file_interface.py:75-382`): KITTI
pose-file IO, chaining relative poses into a global trajectory, and
Umeyama similarity alignment in its three modes (scale-only, 6-DoF, 7-DoF).
"""

from __future__ import annotations

import numpy as np


# -- pose file IO ------------------------------------------------------------

def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry pose file -> (N, 4, 4)."""
    rows = np.loadtxt(path).reshape(-1, 12)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :4] = rows.reshape(-1, 3, 4)
    return out


def save_kitti_poses(path: str, poses: np.ndarray) -> None:
    np.savetxt(path, poses[:, :3, :4].reshape(len(poses), 12))


def load_kitti_poses_indexed(path: str) -> dict[int, np.ndarray]:
    """KITTI pose file, tolerating an optional leading frame-index column.

    Matches `kitti_evaluation_toolkit.py:69-97` (`loadPoses`): 13-number
    lines carry `idx P(3x4)`, 12-number lines are consecutive frames.
    Returns {frame_idx: (4, 4)}.
    """
    poses: dict[int, np.ndarray] = {}
    with open(path) as f:
        for cnt, line in enumerate(f):
            vals = [float(v) for v in line.split()]
            if not vals:
                continue
            with_idx = len(vals) == 13
            P = np.eye(4)
            P[:3, :4] = np.asarray(vals[1:] if with_idx else vals).reshape(3, 4)
            poses[int(vals[0]) if with_idx else cnt] = P
    return poses


def load_tum_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """TUM format (`timestamp tx ty tz qx qy qz qw`, '#' comments) ->
    (timestamps (N,), poses (N, 4, 4)).

    Parity with evo's `read_tum_trajectory_file` (`file_interface.py:75-98`).
    """
    from .transforms import quaternion_matrix

    rows = _read_matrix(path, delim=None)
    if rows.size and rows.shape[1] != 8:
        raise ValueError("TUM trajectory files must have 8 entries per row")
    stamps = rows[:, 0]
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    for i, r in enumerate(rows):
        q = np.roll(r[4:8], 1)  # xyzw -> wxyz
        poses[i] = quaternion_matrix(q)
        poses[i][:3, 3] = r[1:4]
    return stamps, poses


def save_tum_trajectory(path: str, poses: np.ndarray,
                        timestamps: np.ndarray | None = None) -> None:
    """Inverse of `load_tum_trajectory` (`file_interface.py:100-120`)."""
    from .transforms import quaternion_from_matrix

    if timestamps is None:
        timestamps = np.arange(len(poses), dtype=np.float64)
    rows = np.empty((len(poses), 8))
    rows[:, 0] = timestamps
    for i, p in enumerate(poses):
        rows[i, 1:4] = p[:3, 3]
        rows[i, 4:8] = np.roll(quaternion_from_matrix(p), -1)  # wxyz -> xyzw
    np.savetxt(path, rows, delimiter=" ")


def load_euroc_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """EuRoC MAV state-estimate CSV -> (timestamps s, poses (N, 4, 4)).

    `<seq>/mav0/state_groundtruth_estimate0/data.csv`: 17 comma-separated
    columns, ns timestamp, position xyz, quaternion wxyz
    (`file_interface.py:166-186`).
    """
    from .transforms import quaternion_matrix

    rows = _read_matrix(path, delim=",")
    if rows.size and rows.shape[1] != 17:
        raise ValueError("EuRoC state ground truth must have 17 entries per row")
    stamps = rows[:, 0] / 1e9
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    for i, r in enumerate(rows):
        poses[i] = quaternion_matrix(r[4:8])  # already wxyz
        poses[i][:3, 3] = r[1:4]
    return stamps, poses


def _read_matrix(path: str, delim: str | None) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split(delim)])
    return np.asarray(rows, dtype=np.float64)


def accumulate_relative(rel_poses: np.ndarray) -> np.ndarray:
    """Chain per-pair transforms into a global trajectory.

    Matches `scripts/draw_odometry.py:62-77`: global_pose @= inv(T_k),
    starting from identity; returns (N+1, 4, 4).
    """
    n = len(rel_poses)
    out = np.tile(np.eye(4), (n + 1, 1, 1))
    cur = np.eye(4)
    for k, T in enumerate(rel_poses):
        cur = cur @ np.linalg.inv(T)
        out[k + 1] = cur
    return out


def positions(poses: np.ndarray) -> np.ndarray:
    return poses[:, :3, 3]


# -- Umeyama -----------------------------------------------------------------

def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning x (3,N) onto y (3,N).

    Returns (R, t, c) with y ~ c*R@x + t (Umeyama 1991).
    """
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    cov = yc @ xc.T / n
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    R = u @ s @ vt
    if with_scale:
        var_x = (xc ** 2).sum() / n
        c = np.trace(np.diag(d) @ s) / var_x
    else:
        c = 1.0
    t = my[:, 0] - c * R @ mx[:, 0]
    return R, t, c


def align_trajectory(traj: np.ndarray, ref: np.ndarray,
                     correct_scale: bool = True,
                     correct_only_scale: bool = False) -> np.ndarray:
    """Align trajectory poses (N,4,4) onto ref; evo-compatible modes

    (`tools/trajectory.py:367-414`): 7-DoF (default), 6-DoF
    (correct_scale=False), scale-only (correct_only_scale=True).
    """
    x = positions(traj).T
    y = positions(ref).T
    R, t, c = umeyama_alignment(x, y, with_scale=correct_scale or correct_only_scale)
    out = traj.copy()
    if correct_only_scale:
        out[:, :3, 3] *= c
        return out
    S = np.eye(4)
    S[:3, :3] = c * R
    S[:3, 3] = t
    aligned = np.einsum("ij,njk->nik", S, out)
    # Renormalize rotation blocks (remove the scale factor).
    aligned[:, :3, :3] = np.einsum("ij,njk->nik", R, traj[:, :3, :3])
    aligned[:, 3, :] = [0, 0, 0, 1]
    return aligned


def ate_rmse(traj: np.ndarray, ref: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of aligned positions)."""
    aligned = align_trajectory(traj, ref)
    d = positions(aligned) - positions(ref)
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))
