"""Feature-pyramid ResNet (18/34/50/101), counterpart of
`jperceiver_tpu/models/resnet.py`.

Keys follow the torchvision-style ResNet of the reference. The stem is a
plain 7x7/s2 conv on the same weight (the JAX `StemConv` is a TPU rewrite
of it). BatchNorm is `common.BatchNorm2d`, flax's BatchNorm under the
`nn.BatchNorm2d` keys. The stem max-pool has the equality-mask backward of
the JAX `max_pool_3x3_s2`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda import maxpool3x3s2
from .common import BatchNorm2d, CastConv2d, Conv3x3

_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
           101: (3, 4, 23, 3)}


def num_ch_enc(depth: int) -> tuple[int, ...]:
    base = (64, 64, 128, 256, 512)
    if depth > 34:
        return (base[0],) + tuple(c * 4 for c in base[1:])
    return base


def _downsample(c_in, c_out, stride, dtype):
    return nn.Sequential(
        CastConv2d(c_in, c_out, 1, stride=stride, bias=False, dtype=dtype),
        BatchNorm2d(c_out))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, width: int, stride: int, dtype):
        super().__init__()
        self.conv1 = Conv3x3(c_in, width, stride, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv3x3(width, width, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(width)
        self.downsample = (_downsample(c_in, width, stride, dtype)
                           if stride != 1 or c_in != width else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, width: int, stride: int, dtype):
        super().__init__()
        out = width * 4
        self.conv1 = CastConv2d(c_in, width, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv3x3(width, width, stride, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = CastConv2d(width, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (_downsample(c_in, out, stride, dtype)
                           if stride != 1 or c_in != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """Returns the 5-level pyramid [conv1, layer1..layer4]; `in_channels`
    6 is the pose variant (two frames concatenated on channels)."""

    def __init__(self, depth: int = 18, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        block = BasicBlock if depth <= 34 else Bottleneck
        self.conv1 = CastConv2d(in_channels, 64, 7, stride=2, padding=3,
                                bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        c = 64
        for i, (width, n) in enumerate(zip((64, 128, 256, 512), _STAGES[depth])):
            blocks = []
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block(c, width, stride, dtype))
                c = width * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = maxpool3x3s2(y)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            y = layer(y)
            feats.append(y)
        return feats
