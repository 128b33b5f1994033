"""Pose network (counterpart of `jperceiver_tpu/models/pose_net.py`)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import CastConv2d
from .resnet import ResNet, num_ch_enc


class PoseEncoder(nn.Module):
    def __init__(self, depth: int = 18, num_input_images: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = ResNet(depth, 3 * num_input_images, dtype)

    def forward(self, imgs: torch.Tensor) -> list[torch.Tensor]:
        """imgs: (B, 3 * num_input_images, H, W)."""
        return self.encoder((imgs - 0.45) / 0.225)


class PoseDecoder(nn.Module):
    def __init__(self, depth: int = 18, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reduce = CastConv2d(num_ch_enc(depth)[-1], 256, 1, dtype=dtype)
        self.conv1 = CastConv2d(256, 256, 3, padding=1, dtype=dtype)
        self.conv2 = CastConv2d(256, 256, 3, padding=1, dtype=dtype)
        self.conv3 = CastConv2d(256, 6, 1, dtype=dtype)

    def forward(self, feats):
        """-> (axisangle (B, 3), translation (B, 3)) in the compute dtype."""
        y = F.relu(self.reduce(feats[-1]))
        y = F.relu(self.conv1(y))
        y = F.relu(self.conv2(y))
        y = self.conv3(y).mean((2, 3)) * 0.01
        return y[:, :3], y[:, 3:]
