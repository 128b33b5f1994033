"""SSIM dissimilarity with 3x3 mean windows and reflection padding
(counterpart of `jperceiver_tpu/ops/ssim.py`).

Returns clip((1 - SSIM)/2, 0, 1) per pixel and channel. Tensors are
(..., C, H, W) with identical trailing (C, H, W); leading dims broadcast, so
a target passed as (B, 1, C, H, W) against predictions (P, B, F, C, H, W)
has its window statistics computed once.

The clip is a maximum then a minimum, as `jnp.clip` is, so its gradient on
the ends of [0, 1] is one half, as in JAX.
"""

from __future__ import annotations

import torch

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _win3(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim] - 2
    return x.narrow(dim, 0, n) + x.narrow(dim, 1, n) + x.narrow(dim, 2, n)


def reflect_pad_hw(x: torch.Tensor) -> torch.Tensor:
    """1-pixel reflection pad of the last two dims (the edge not repeated)."""
    h, w = x.shape[-2], x.shape[-1]
    x = torch.cat([x[..., 1:2, :], x, x[..., h - 2:h - 1, :]], -2)
    return torch.cat([x[..., 1:2], x, x[..., w - 2:w - 1]], -1)


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID mean over the last two dims: rows, then columns."""
    return _win3(_win3(x, -2), -1) / 9.0


def clip01(z: torch.Tensor) -> torch.Tensor:
    """`jnp.clip(z, 0, 1)`: maximum then minimum, ties splitting the gradient."""
    return torch.minimum(torch.maximum(z, z.new_tensor(0.0)), z.new_tensor(1.0))


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) pair -> per-pixel SSIM dissimilarity in [0, 1]."""
    xp = reflect_pad_hw(x)
    yp = reflect_pad_hw(y)
    mu_x = _avg_pool3(xp)
    mu_y = _avg_pool3(yp)
    sigma_x = _avg_pool3(xp * xp) - mu_x * mu_x
    sigma_y = _avg_pool3(yp * yp) - mu_y * mu_y
    sigma_xy = _avg_pool3(xp * yp) - mu_x * mu_y
    num = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    den = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return clip01((1.0 - num / den) * 0.5)
