"""Depth encoder and CRP decoder (counterpart of
`jperceiver_tpu/models/depth_net.py`)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sampling import upsample2x_nearest
from .common import Conv1x1, ConvReflect3x3, CRPBlock, dropout
from .resnet import ResNet, num_ch_enc


class DepthEncoder(nn.Module):
    def __init__(self, depth: int = 18, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = ResNet(depth, dtype=dtype)

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        return self.encoder((img - 0.45) / 0.225)


class DepthDecoder(nn.Module):
    """Four levels of iconv -> CRP -> merge -> x2 up -> sigmoid disp head.

    The iconv is one reflect-pad 3x3 conv over the channel concat
    [reduced skip, upsampled previous level, previous disp]; the JAX
    `ConvReflect3x3Split` computes the same conv part by part. In training,
    dropout at `dropout_rate` (0.5, as in JAX) is applied to l4 and l3,
    drawn from the `generator` passed to `forward`.
    """

    def __init__(self, depth: int = 18, bottleneck: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        enc = num_ch_enc(depth)
        bn = bottleneck
        self.dropout_rate = 0.5
        for i in (4, 3, 2, 1):
            c_red = 512 if i == 4 else bn
            self.add_module(f"reduce{i}", Conv1x1(enc[i], c_red, dtype=dtype))
            c_cat = c_red if i == 4 else c_red + bn + 1
            self.add_module(f"iconv{i}", ConvReflect3x3(c_cat, bn, dtype))
            self.add_module(f"crp{i}", nn.Sequential(CRPBlock(bn, 4, dtype)))
            self.add_module(f"merge{i}", ConvReflect3x3(bn, bn, dtype))
            self.add_module(f"disp{i}", nn.Sequential(
                ConvReflect3x3(bn, 1, dtype), nn.Sigmoid()))

    def forward(self, feats: list[torch.Tensor],
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        if self.training and self.dropout_rate:
            feats = list(feats)
            for i in (4, 3):
                feats[i] = dropout(feats[i], self.dropout_rate, generator)
        out = {}
        x = disp = None
        for i in (4, 3, 2, 1):
            parts = [getattr(self, f"reduce{i}")(feats[i])]
            if x is not None:
                parts += [x, disp]
            y = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
            y = F.leaky_relu(getattr(self, f"iconv{i}")(y), 0.01)
            y = getattr(self, f"crp{i}")(y)
            y = F.leaky_relu(getattr(self, f"merge{i}")(y), 0.01)
            x = upsample2x_nearest(y)
            disp = getattr(self, f"disp{i}")(x)
            out[f"disp/{i - 1}"] = disp
        return out
