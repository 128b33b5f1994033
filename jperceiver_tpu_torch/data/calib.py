"""KITTI calibration parsing, odometry and raw (the port's own copy of
`jperceiver_tpu/data/calib.py`), with no pykitti dependency.

Produces the two quantities the model consumes — `K_cam2` and
`T_cam2_velo` — with pykitti's composition semantics (the reference loads
them via `pykitti.odometry(...)` / `pykitti.raw(...)`,
`kitti_dataset.py:296-314,352-374`):

* odometry: `calib.txt` holds P0..P3 and Tr (velo -> cam0-rect).
  T_cam2_velo = T2 @ Tr, where T2 shifts by the cam2 baseline
  (-P2[0,3]/P2[0,0] along x). K_cam2 = P2[:3,:3].
* raw: `calib_velo_to_cam.txt` (R|T) and `calib_cam_to_cam.txt`
  (R_rect_00, P_rect_02). T_cam2_velo = T2 @ R_rect00 @ T_velo_cam,
  K_cam2 = P_rect_02[:3,:3].
"""

from __future__ import annotations

import os

import numpy as np


def read_calib_file(path: str) -> dict[str, np.ndarray]:
    """KITTI `key: v0 v1 ...` calibration format -> dict of float arrays."""
    out: dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                key, val = line.split(":", 1)
            else:
                key, val = line.split(" ", 1)
            try:
                out[key.strip()] = np.asarray(
                    [float(x) for x in val.split()], np.float64
                )
            except ValueError:
                pass
    return out


def _pad44(mat34: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :4] = mat34
    return out


def _baseline_shift(P: np.ndarray) -> np.ndarray:
    """cam0-rect -> camN-rect: translate by -P[0,3]/P[0,0] along x."""
    T = np.eye(4)
    T[0, 3] = -P[0, 3] / P[0, 0]
    return T


def load_odometry_calib(sequence_dir: str):
    """`<seq>/calib.txt` -> (K_cam2 (4,4), T_cam2_velo (4,4)), float32."""
    data = read_calib_file(os.path.join(sequence_dir, "calib.txt"))
    P2 = data["P2"].reshape(3, 4)
    Tr = _pad44(data["Tr"].reshape(3, 4))
    T_cam2_velo = _baseline_shift(P2) @ Tr
    K = np.eye(4)
    K[:3, :3] = P2[:3, :3]
    return K.astype(np.float32), T_cam2_velo.astype(np.float32)


def load_raw_calib(date_dir: str):
    """KITTI RAW `<date>/calib_*.txt` -> (K_cam2 (4,4), T_cam2_velo (4,4))."""
    v2c = read_calib_file(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    c2c = read_calib_file(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    T_velo_cam0 = np.eye(4)
    T_velo_cam0[:3, :3] = v2c["R"].reshape(3, 3)
    T_velo_cam0[:3, 3] = v2c["T"]
    R_rect = np.eye(4)
    R_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    P2 = c2c["P_rect_02"].reshape(3, 4)
    T_cam2_velo = _baseline_shift(P2) @ R_rect @ T_velo_cam0
    K = np.eye(4)
    K[:3, :3] = P2[:3, :3]
    return K.astype(np.float32), T_cam2_velo.astype(np.float32)
