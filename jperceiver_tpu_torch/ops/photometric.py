"""Photometric reprojection loss, monodepth2-style (counterpart of
`jperceiver_tpu/ops/photometric.py`). Images are (..., C, H, W)."""

from __future__ import annotations

import torch

from .ssim import ssim


def robust_l1(pred: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-3) -> torch.Tensor:
    """Charbonnier residual sqrt((target - pred)^2 + eps^2)."""
    return torch.sqrt((target - pred) ** 2 + eps * eps)


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * robust L1, channel-averaged -> (..., 1, H, W)."""
    photo = robust_l1(pred, target).mean(-3, keepdim=True)
    struct = ssim(pred, target).mean(-3, keepdim=True)
    return 0.85 * struct + 0.15 * photo
