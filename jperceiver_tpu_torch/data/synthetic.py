"""Synthetic eval batches (the port's own copy of
`jperceiver_tpu/data/synthetic.py`, cut to what eval reads)."""

from __future__ import annotations

import numpy as np


def synthetic_batch(batch: int = 2, height: int = 64, width: int = 64,
                    num_frames: int = 3, seed: int = 0, dtype=np.float32):
    """{"color_aug" (B, F, 3, H, W), "K", "inv_K" (B, 4, 4)} as numpy.

    Draws from the generator in the JAX package's order, so with the same
    seed `color_aug` is the JAX batch's (B, F, H, W, 3) array, transposed.
    """
    rng = np.random.default_rng(seed)
    # Normalized-K convention of the KITTI loaders, scaled by the input size.
    K = np.array(
        [
            [0.58 * width, 0, 0.5 * width, 0],
            [0, 1.92 * height, 0.5 * height, 0],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ],
        dtype,
    )
    inv_K = np.linalg.pinv(K).astype(dtype)
    color = rng.uniform(0, 1, (batch, num_frames, height, width, 3)).astype(dtype)
    color_aug = np.clip(
        color + rng.normal(0, 0.02, color.shape).astype(dtype), 0, 1)
    return {
        "color_aug": np.ascontiguousarray(color_aug.transpose(0, 1, 4, 2, 3)),
        "K": np.tile(K[None], (batch, 1, 1)),
        "inv_K": np.tile(inv_K[None], (batch, 1, 1)),
    }
