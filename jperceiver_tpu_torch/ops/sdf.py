"""Host-side signed distance field of a label map, for the boundary loss
(the port's own numpy/scipy copy of `jperceiver_tpu/ops/sdf.py`). It
depends only on the labels, so it is computed with the batch, not in the
step."""

from __future__ import annotations

import numpy as np


def _inner_boundary(mask: np.ndarray) -> np.ndarray:
    """Pixels of `mask` with a 4- or 8-connected background neighbour."""
    padded = np.pad(mask, 1, mode="constant", constant_values=False)
    neigh_all_fg = np.ones_like(mask, dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh_all_fg &= padded[1 + dy:1 + dy + mask.shape[0],
                                       1 + dx:1 + dx + mask.shape[1]]
    return mask & ~neigh_all_fg


def signed_distance_field(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Per-foreground-class SDF of an (H, W) or (B, H, W) integer label map
    -> (..., C-1, H, W) float32: negative inside the class, positive
    outside, zero on its inner boundary; all zero for an absent class."""
    from scipy.ndimage import distance_transform_edt

    labels = np.asarray(labels)
    if labels.ndim == 3:
        return np.stack([signed_distance_field(l, num_classes) for l in labels])
    out = np.zeros((num_classes - 1,) + labels.shape, np.float32)
    for c in range(1, num_classes):
        pos = labels == c
        if pos.any():
            sdf = distance_transform_edt(~pos) - distance_transform_edt(pos)
            sdf[_inner_boundary(pos)] = 0.0
            out[c - 1] = sdf
    return out
