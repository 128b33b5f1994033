"""Velodyne -> depth-map projection, the KITTI ground truth (the port's
own copy of `jperceiver_tpu/data/velodyne.py`, its numpy path). Points are
sorted by (pixel, depth) and the smallest depth of a pixel wins.
"""

from __future__ import annotations

import os

import numpy as np

from .calib import read_calib_file


def load_velodyne_points(filename: str) -> np.ndarray:
    pts = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def velo_to_image_projection(calib_dir: str, cam: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """(P_velo2im (3,4), image shape (2,)) from a RAW calib directory."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_raw["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_raw["T"]
    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)
    return P_rect @ R_rect @ velo2cam, im_shape


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse depth map at the rectified camera resolution."""
    P, im_shape = velo_to_image_projection(calib_dir, cam)
    h, w = int(im_shape[0]), int(im_shape[1])

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0]

    pts = (P @ velo.T).T
    pts[:, :2] /= pts[:, 2:3]
    depth_vals = velo[:, 0] if vel_depth else pts[:, 2]

    # KITTI matlab convention: round then shift by 1 (`kitti_utils.py:81-83`).
    xs = np.round(pts[:, 0]) - 1
    ys = np.round(pts[:, 1]) - 1
    valid = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
    xs = xs[valid].astype(np.int64)
    ys = ys[valid].astype(np.int64)
    depth_vals = depth_vals[valid]

    # Min-depth-per-pixel: sort by (pixel, depth); first occurrence wins.
    lin = ys * w + xs
    order = np.lexsort((depth_vals, lin))
    lin, depth_vals = lin[order], depth_vals[order]
    first = np.ones(lin.shape[0], bool)
    first[1:] = lin[1:] != lin[:-1]

    depth = np.zeros((h, w), np.float32)
    depth.flat[lin[first]] = depth_vals[first]
    depth[depth < 0] = 0
    return depth
