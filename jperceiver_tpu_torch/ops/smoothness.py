"""First- and second-order edge-aware disparity smoothness (counterpart of
`jperceiver_tpu/ops/smoothness.py`): forward differences, image gradients
gate the penalty through exp(-0.5 |dI|), the loss is the sum of the six
mean terms. Tensors are NCHW."""

from __future__ import annotations

import torch

from .sampling import resize_area


def _grad(d: torch.Tensor):
    """(dx, dy) forward differences; each shrinks by 1 along its axis."""
    return d[:, :, :, 1:] - d[:, :, :, :-1], d[:, :, 1:, :] - d[:, :, :-1, :]


def edge_aware_smoothness(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """disp (B, 1, h, w); img (B, 3, H, W), area-downsampled here to h x w."""
    img = resize_area(img, disp.shape[2], disp.shape[3])
    disp_dx, disp_dy = _grad(disp)
    img_dx, img_dy = _grad(img)
    disp_dxx, disp_dxy = _grad(disp_dx)
    disp_dyx, disp_dyy = _grad(disp_dy)
    img_dxx, img_dxy = _grad(img_dx)
    img_dyx, img_dyy = _grad(img_dy)

    def term(dd, di):
        gate = torch.exp(-0.5 * di.abs().mean(1, keepdim=True))
        return (dd.abs() * gate).mean()

    smooth1 = term(disp_dx, img_dx) + term(disp_dy, img_dy)
    smooth2 = (term(disp_dxx, img_dxx) + term(disp_dxy, img_dxy)
               + term(disp_dyx, img_dyx) + term(disp_dyy, img_dyy))
    return smooth1 + smooth2
