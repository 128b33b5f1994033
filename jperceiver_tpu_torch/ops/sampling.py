"""Resizes of the inference path (counterpart of the matching functions of
`jperceiver_tpu/ops/sampling.py`). Images are NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize, half-pixel centres, antialiased when it downsamples.

    `jax.image.resize` widens its triangle kernel by the downsampling
    factor; `antialias=True` is the same filter. Without it the 1024^2 ->
    192x640 pose resize differs from the JAX package by up to 0.47.
    """
    return F.interpolate(img, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


def upsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """x2 nearest-neighbour upsample."""
    return F.interpolate(img, scale_factor=2, mode="nearest")
