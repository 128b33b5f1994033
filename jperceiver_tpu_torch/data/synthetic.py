"""Synthetic training batches (the port's own copy of
`jperceiver_tpu/data/synthetic.py`), in NCHW."""

from __future__ import annotations

import numpy as np

from ..ops.sdf import signed_distance_field


def kitti_like_calib():
    """Plausible KITTI odometry calibration: K from sequence-00-style
    intrinsics; Tr_cam2_velo with the velodyne -> camera axis permutation
    (x_c = -y_v, y_c = -z_v, z_c = x_v)."""
    K = np.array([[707.09, 0.0, 601.89, 0.0], [0.0, 707.09, 183.11, 0.0],
                  [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]], np.float32)
    Tr = np.array([[0.0, -1.0, 0.0, -0.01], [0.0, 0.0, -1.0, -0.075],
                   [1.0, 0.0, 0.0, -0.27], [0.0, 0.0, 0.0, 1.0]], np.float32)
    return K, Tr


def synthetic_batch(batch: int = 2, height: int = 64, width: int = 64,
                    occ_map_size: int = 16, num_frames: int = 3, seed: int = 0,
                    dtype=np.float32) -> dict:
    """A whole training batch as numpy, the JAX batch transposed to NCHW:
    "color", "color_aug" (B, F, 3, H, W); "K", "inv_K", "odometry_K",
    "Tr_cam2_velo" (B, 4, 4); "bev_static", "bev_dynamic" (B, S, S) int32;
    "bev_both" (B, S, S) float; "bev_static_sdf", "bev_dynamic_sdf"
    (B, 1, S, S). Draws from the generator in the JAX package's order, so
    the same seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    K_full, Tr = kitti_like_calib()
    # Normalized-K convention of the KITTI loaders, scaled by the input size.
    K = np.array([[0.58 * width, 0, 0.5 * width, 0], [0, 1.92 * height, 0.5 * height, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], dtype)
    inv_K = np.linalg.pinv(K).astype(dtype)
    color = rng.uniform(0, 1, (batch, num_frames, height, width, 3)).astype(dtype)
    color_aug = np.clip(color + rng.normal(0, 0.02, color.shape).astype(dtype), 0, 1)
    s = occ_map_size
    bev = np.zeros((batch, s, s), np.int32)
    bev[:, s // 4:s - 2, s // 3:2 * s // 3] = 1  # a road-ish blob
    bev_d = np.zeros((batch, s, s), np.int32)
    bev_d[:, s // 2:s // 2 + 3, s // 2:s // 2 + 2] = 1

    def nchw(a):
        return np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3))

    return {
        "color": nchw(color),
        "color_aug": nchw(color_aug),
        "K": np.tile(K[None], (batch, 1, 1)),
        "inv_K": np.tile(inv_K[None], (batch, 1, 1)),
        "odometry_K": np.tile(K_full[None], (batch, 1, 1)),
        "Tr_cam2_velo": np.tile(Tr[None], (batch, 1, 1)),
        "bev_static": bev,
        "bev_dynamic": bev_d,
        "bev_both": bev.astype(dtype),
        "bev_static_sdf": signed_distance_field(bev, 2).astype(dtype),
        "bev_dynamic_sdf": signed_distance_field(bev_d, 2).astype(dtype),
    }
