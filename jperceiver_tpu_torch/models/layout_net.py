"""BEV layout branch: encoder, cycled view projection (CVP), cross-view
cross-modal transformer (CCT) and layout decoder (counterpart of
`jperceiver_tpu/models/layout_net.py`)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sampling import upsample2x_nearest
from .common import (BatchNorm2d, CastConv2d, CastLinear, Conv3x3,
                     ConvReflect3x3)
from .resnet import ResNet, num_ch_enc


class _ResnetEncoder(nn.Module):
    """Holds the trunk under `.encoder`, as the reference's keys do."""

    def __init__(self, depth: int, dtype):
        super().__init__()
        self.encoder = ResNet(depth, dtype=dtype)


class LayoutEncoder(nn.Module):
    """Front-view image -> (B, 128, S/32, S/32) with S = occ_map_size."""

    def __init__(self, depth: int = 18, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnet_encoder = _ResnetEncoder(depth, dtype)
        self.conv1 = ConvReflect3x3(num_ch_enc(depth)[-1], 128, dtype)
        self.conv2 = ConvReflect3x3(128, 128, dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        feats = self.resnet_encoder.encoder((img - 0.45) / 0.225)
        y = F.max_pool2d(self.conv1(feats[-1]), 2, 2)
        return F.max_pool2d(self.conv2(y), 2, 2)


class TransformModule(nn.Module):
    """Per-channel MLP over the flattened spatial dim."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        n = dim * dim
        self.dim = dim
        self.fc_transform = nn.Sequential(
            CastLinear(n, n, dtype=dtype), nn.ReLU(),
            CastLinear(n, n, dtype=dtype), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if (h, w) != (self.dim, self.dim):
            raise ValueError(f"TransformModule({self.dim}): got {h}x{w}")
        return self.fc_transform(x.reshape(b, c, h * w)).reshape(b, c, h, w)


class CycledViewProjection(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transform_module = TransformModule(dim, dtype)
        self.retransform_module = TransformModule(dim, dtype)

    def forward(self, x: torch.Tensor):
        transform = self.transform_module(x)
        return transform, self.retransform_module(transform)


class _GatherRows(torch.autograd.Function):
    """(B, N, C) rows, (B, M) indices -> (B, M, C): `t[b, j] = v[b, idx[b, j]]`.
    The forward is `torch.gather`; the backward is the one-hot product
    `onehot(idx)^T @ g` in fp32, where `gather`'s backward (`scatter_add`)
    adds the cotangents of rows picked more than once atomically, in an
    order that changes from run to run on CUDA."""

    @staticmethod
    def forward(ctx, v, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = v.shape[1], v.dtype
        return torch.gather(v, 1, idx[..., None].expand(-1, -1, v.shape[2]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.promote_types(g.dtype, torch.float32)
        # (B, M, N); a comparison, as `F.one_hot` reads idx's range back to the host.
        onehot = (idx[..., None] == torch.arange(ctx.n, device=idx.device)).to(acc)
        return torch.bmm(onehot.transpose(1, 2), g.to(acc)).to(ctx.dtype), None


class CrossViewTransformer(nn.Module):
    """CCT attention.

    Cross-view: hard attention -- for every front-view position the max
    similarity against the cycled top-view features picks a value vector
    (argmax) and scales the fused residual. Cross-modal: the same
    max-similarity map mixes in depth features through the reference's
    `attn @ V` quirk, an (h, w) x (h, w) matmul broadcast over channels.
    """

    def __init__(self, features: int = 128, depth_channels: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, qk = features, features // 8
        self.conv1 = ConvReflect3x3(depth_channels, 128, dtype)
        self.conv2 = ConvReflect3x3(128, 128, dtype)
        self.query_conv = CastConv2d(c, qk, 1, dtype=dtype)
        self.key_conv = CastConv2d(c, qk, 1, dtype=dtype)
        self.value_conv = CastConv2d(c, c, 1, dtype=dtype)
        self.f_conv = CastConv2d(2 * c, c, 3, padding=1, dtype=dtype)
        self.query_conv_depth = CastConv2d(c, qk, 1, dtype=dtype)
        self.key_conv_depth = CastConv2d(c, qk, 1, dtype=dtype)
        self.value_conv_depth = CastConv2d(128, c, 1, dtype=dtype)

    def forward(self, front_x, cross_x, front_x_hat, depth_feature):
        b, c, h, w = front_x.shape
        d = F.max_pool2d(self.conv1(depth_feature), 2, 2)
        d = F.max_pool2d(self.conv2(d), 2, 2)

        def rows(t):  # (B, C, h, w) -> (B, h*w, C)
            return t.flatten(2).transpose(1, 2)

        q = rows(self.query_conv(cross_x))
        k = rows(self.key_conv(front_x))
        v = rows(self.value_conv(front_x_hat))
        # energy[b, i, j] = <key_i, query_j>; reduce over key positions i.
        energy = torch.bmm(k, q.transpose(1, 2))
        score = energy.amax(1)
        idx = energy.argmax(1)
        t = _GatherRows.apply(v, idx)
        t = t.transpose(1, 2).reshape(b, c, h, w)
        s_map = score.reshape(b, 1, h, w)
        fused = self.f_conv(torch.cat([front_x, t], 1))
        out = front_x + fused * s_map

        qd = rows(self.query_conv_depth(cross_x))
        kd = rows(self.key_conv_depth(front_x))
        vd = self.value_conv_depth(d)  # (B, C, h, w)
        attn = torch.bmm(kd, qd.transpose(1, 2)).amax(1).reshape(b, 1, h, w)
        out = out + torch.matmul(attn, vd)
        return out, s_map, attn


class LayoutDecoder(nn.Module):
    """(B, 128, S/32, S/32) -> (B, num_class, S, S) logits.

    `decoder` is indexed like the reference's ModuleList: for each level
    i = 4..0 the five entries [upconv_i_0, norm_i_0, relu, upconv_i_1,
    norm_i_1], then the topview head at 25.
    """

    def __init__(self, num_class: int = 2, in_channels: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        c = in_channels
        for ch in (256, 128, 64, 32, 16):
            layers += [Conv3x3(c, ch, dtype=dtype), BatchNorm2d(ch),
                       nn.ReLU(), Conv3x3(ch, ch, dtype=dtype),
                       BatchNorm2d(ch)]
            c = ch
        layers.append(ConvReflect3x3(c, num_class, dtype))
        self.decoder = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dec = self.decoder
        for base in range(0, 25, 5):
            x = F.relu(dec[base + 1](dec[base](x)))
            x = upsample2x_nearest(x)
            x = dec[base + 4](dec[base + 3](x))
        return dec[25](x)
