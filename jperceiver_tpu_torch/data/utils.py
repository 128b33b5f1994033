"""Misc data/eval utilities (parity with `mono/datasets/utils.py`).

The port's own copy of `jperceiver_tpu/data/utils.py` (numpy only)."""

from __future__ import annotations

import numpy as np


def normalize_image(x: np.ndarray) -> np.ndarray:
    """Rescale to [0, 1] for visualization (`utils.py:19-25`)."""
    ma, mi = float(x.max()), float(x.min())
    return (x - mi) / (ma - mi if ma != mi else 1e5)


def sec_to_hm(t: float):
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return t, m, s


def sec_to_hm_str(t: float) -> str:
    h, m, s = sec_to_hm(t)
    return f"{h:02d}h{m:02d}m{s:02d}s"


def dump_xyz(transforms) -> np.ndarray:
    """Chain local transforms into global xyz positions (`utils.py:105-112`)."""
    cam_to_world = np.eye(4)
    xyzs = [cam_to_world[:3, 3].copy()]
    for t in transforms:
        cam_to_world = cam_to_world @ np.linalg.inv(t)
        xyzs.append(cam_to_world[:3, 3].copy())
    return np.asarray(xyzs)


def compute_ate(gtruth_xyz: np.ndarray, pred_xyz_o: np.ndarray) -> float:
    """Scale-aligned absolute trajectory error (`utils.py:115-122`)."""
    scale = np.sum(gtruth_xyz * pred_xyz_o) / np.sum(pred_xyz_o ** 2)
    alignment_error = pred_xyz_o * scale - gtruth_xyz
    return float(np.sqrt(np.sum(alignment_error ** 2)) / gtruth_xyz.shape[0])


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray) -> np.ndarray:
    """Flip-fusion of left/flipped-right disparities (`utils.py:165-173`):

    blend with a 20-pixel-wide ramp on each border.
    """
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    grid = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h), indexing="xy")
    l_mask = (1.0 - np.clip(20 * (grid[0] - 0.05), 0, 1))[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp
