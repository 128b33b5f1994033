"""The plain reference of the JPerceiver model: depth, pose and BEV layout
networks in plain PyTorch, fp32 by default.

It is written from the model's definition, not from the code under test,
and imports nothing of it: every convolution is `F.conv2d`, every pool
`F.max_pool2d`, every resize `F.interpolate`, BatchNorm is `F.batch_norm`
on the batch in training and on the running statistics in eval. Module
names follow the reference `Baseline` state-dict keys, so one state dict
loads into the program and into this model alike.

`Precision` says how the convolutions and matrix products compute: plain
(the operands as they are); `tf32`, what cuDNN's default does to an fp32
convolution: each convolution's operands, and each gradient that reaches
a convolution's backward, rounded to TensorFloat-32 (10 mantissa bits),
the matrix products left in fp32 as PyTorch's default leaves them; or
`bf16`, every product's operands and gradients rounded to bfloat16.
bf16 is the benchmark's control: the precision below the float32 (with
cuDNN's TF32) that the configurations state. tf32 measures, on each
seed, how far the program's own rounding moves the plain formula: the
unit of the numbers that decide `correct` (`compare.py`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

POSE_INPUT_HW = (192, 640)


class Precision:
    """What the reference's products compute in: None (the operands as
    they are), "tf32" or "bf16"."""

    mode: str | None = None


@contextlib.contextmanager
def precision(mode: str | None):
    before = Precision.mode
    Precision.mode = mode
    try:
        yield
    finally:
        Precision.mode = before


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t (fp32) rounded to nearest, ties to even, at 10 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32).view_as(t)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# Precision -> (forward operand rounding, gradient rounding, whether the
# matrix products round too or only the convolutions).
_ROUND = {"tf32": (_tf32, _tf32, False), "bf16": (_bf16, _bf16, True)}


def _rounds(conv: bool) -> bool:
    mode = Precision.mode
    return mode is not None and (conv or _ROUND[mode][2])


def operand(t: torch.Tensor, conv: bool = True) -> torch.Tensor:
    """A product's operand in the current precision, with a
    straight-through gradient."""
    if not _rounds(conv):
        return t
    return t + (_ROUND[Precision.mode][0](t.detach()) - t).detach()


class _GradRound(torch.autograd.Function):
    """The identity, whose backward rounds the gradient as the precision
    rounds a product's gradient operand."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[Precision.mode][1](g)


def product(y: torch.Tensor, conv: bool = True) -> torch.Tensor:
    """A product's output, whose gradient reaches the product's backward
    rounded as the precision says."""
    if not _rounds(conv) or not y.requires_grad:
        return y
    return _GradRound.apply(y)


def conv(x, weight, bias=None, stride=1, padding=0):
    return product(F.conv2d(operand(x), operand(weight), bias, stride, padding))


def bmm(a, b):
    return product(torch.bmm(operand(a, False), operand(b, False)), False)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return conv(x, self.weight, self.bias, self.stride, self.padding)


class Linear(nn.Linear):
    def forward(self, x):
        return product(F.linear(operand(x, False), operand(self.weight, False), self.bias),
                       False)


class ConvReflect3x3(nn.Module):
    """Reflection pad 1, then a 3x3 conv with bias."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class Conv1x1(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, 1, bias=False)

    def forward(self, x):
        return self.conv(x)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch statistics (biased variance) in training, running ones in
    eval; momentum 0.1 on the running statistics, eps 1e-5."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, self.momentum, self.eps)


class BasicBlock(nn.Module):
    def __init__(self, c_in, width, stride):
        super().__init__()
        self.conv1 = Conv2d(c_in, width, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.downsample = None
        if stride != 1 or c_in != width:
            self.downsample = nn.Sequential(Conv2d(c_in, width, 1, stride, bias=False),
                                            BatchNorm2d(width))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    """1x1, 3x3 carrying the stride, 1x1 to four times the width, each
    followed by BatchNorm (torchvision's v1.5 layout)."""

    def __init__(self, c_in, width, stride):
        super().__init__()
        out = 4 * width
        self.conv1 = Conv2d(c_in, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or c_in != out:
            self.downsample = nn.Sequential(Conv2d(c_in, out, 1, stride, bias=False),
                                            BatchNorm2d(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


# Blocks a stage of each depth (He et al. 2016, arXiv:1512.03385, table 1).
STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def pyramid(depth: int) -> tuple[int, ...]:
    """The channels of the five levels [stem, layer1..layer4]: basic blocks
    below 50, bottlenecks four times as wide from 50 on."""
    return (64, 64, 128, 256, 512) if depth < 50 else (64, 256, 512, 1024, 2048)


class ResNet(nn.Module):
    """The five-level pyramid [stem, layer1..layer4] of a ResNet of
    `depth` 18, 34, 50 or 101."""

    def __init__(self, depth=18, in_channels=3):
        super().__init__()
        block = BasicBlock if depth < 50 else Bottleneck
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        c = 64
        for i, (width, out, n) in enumerate(zip((64, 128, 256, 512), pyramid(depth)[1:],
                                                 STAGES[depth])):
            blocks = [block(c if j == 0 else out, width, 2 if i > 0 and j == 0 else 1)
                      for j in range(n)]
            c = out
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            y = layer(y)
            feats.append(y)
        return feats


class _Holder(nn.Module):
    def __init__(self, depth=18, in_channels=3):
        super().__init__()
        self.encoder = ResNet(depth, in_channels)


class DepthEncoder(_Holder):
    def forward(self, img):
        return self.encoder((img - 0.45) / 0.225)


class PoseEncoder(_Holder):
    def __init__(self, depth=18):
        super().__init__(depth, 6)

    def forward(self, pair):
        return self.encoder((pair - 0.45) / 0.225)


class CRPBlock(nn.Module):
    def __init__(self, features, n_stages=4):
        super().__init__()
        self.n_stages = n_stages
        for i in range(1, n_stages + 1):
            self.add_module(f"{i}_pointwise", Conv1x1(features, features))

    def forward(self, x):
        top = x
        for i in range(1, self.n_stages + 1):
            top = getattr(self, f"{i}_pointwise")(F.max_pool2d(top, 5, 1, 2))
            x = top + x
        return x


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(img, h, w):
    return F.interpolate(img, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


class DepthDecoder(nn.Module):
    def __init__(self, depth=18, bottleneck=256):
        super().__init__()
        enc = pyramid(depth)
        for i in (4, 3, 2, 1):
            c_red = 512 if i == 4 else bottleneck
            self.add_module(f"reduce{i}", Conv1x1(enc[i], c_red))
            c_cat = c_red if i == 4 else c_red + bottleneck + 1
            self.add_module(f"iconv{i}", ConvReflect3x3(c_cat, bottleneck))
            self.add_module(f"crp{i}", nn.Sequential(CRPBlock(bottleneck, 4)))
            self.add_module(f"merge{i}", ConvReflect3x3(bottleneck, bottleneck))
            self.add_module(f"disp{i}", nn.Sequential(ConvReflect3x3(bottleneck, 1),
                                                      nn.Sigmoid()))

    def forward(self, feats):
        out, x, disp = {}, None, None
        for i in (4, 3, 2, 1):
            y = getattr(self, f"reduce{i}")(feats[i])
            if x is not None:
                y = torch.cat([y, x, disp], 1)
            y = F.leaky_relu(getattr(self, f"iconv{i}")(y), 0.01)
            y = F.leaky_relu(getattr(self, f"merge{i}")(getattr(self, f"crp{i}")(y)), 0.01)
            x = upsample2x(y)
            disp = getattr(self, f"disp{i}")(x)
            out[f"disp/{i - 1}"] = disp
        return out


class PoseDecoder(nn.Module):
    def __init__(self, depth=18):
        super().__init__()
        self.reduce = Conv2d(pyramid(depth)[-1], 256, 1)
        self.conv1 = Conv2d(256, 256, 3, 1, 1)
        self.conv2 = Conv2d(256, 256, 3, 1, 1)
        self.conv3 = Conv2d(256, 6, 1)

    def forward(self, feats):
        y = F.relu(self.reduce(feats[-1]))
        y = F.relu(self.conv2(F.relu(self.conv1(y))))
        y = self.conv3(y).mean((2, 3)) * 0.01
        return y[:, :3], y[:, 3:]


class LayoutEncoder(nn.Module):
    def __init__(self, depth=18):
        super().__init__()
        self.resnet_encoder = _Holder(depth)
        self.conv1 = ConvReflect3x3(pyramid(depth)[-1], 128)
        self.conv2 = ConvReflect3x3(128, 128)

    def forward(self, img):
        feats = self.resnet_encoder.encoder((img - 0.45) / 0.225)
        y = F.max_pool2d(self.conv1(feats[-1]), 2, 2)
        return F.max_pool2d(self.conv2(y), 2, 2)


class TransformModule(nn.Module):
    def __init__(self, dim):
        super().__init__()
        n = dim * dim
        self.fc_transform = nn.Sequential(Linear(n, n), nn.ReLU(), Linear(n, n), nn.ReLU())

    def forward(self, x):
        b, c, h, w = x.shape
        return self.fc_transform(x.reshape(b, c, h * w)).reshape(b, c, h, w)


class CycledViewProjection(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.transform_module = TransformModule(dim)
        self.retransform_module = TransformModule(dim)

    def forward(self, x):
        t = self.transform_module(x)
        return t, self.retransform_module(t)


class CrossViewTransformer(nn.Module):
    """Hard cross-view attention (the argmax over key positions picks a
    value row) and the cross-modal `attn @ V` over depth features."""

    def __init__(self, c=128, depth_channels=512):
        super().__init__()
        qk = c // 8
        self.conv1 = ConvReflect3x3(depth_channels, 128)
        self.conv2 = ConvReflect3x3(128, 128)
        self.query_conv = Conv2d(c, qk, 1)
        self.key_conv = Conv2d(c, qk, 1)
        self.value_conv = Conv2d(c, c, 1)
        self.f_conv = Conv2d(2 * c, c, 3, 1, 1)
        self.query_conv_depth = Conv2d(c, qk, 1)
        self.key_conv_depth = Conv2d(c, qk, 1)
        self.value_conv_depth = Conv2d(128, c, 1)

    def forward(self, front, cross, front_hat, depth_feature):
        b, c, h, w = front.shape
        d = F.max_pool2d(self.conv1(depth_feature), 2, 2)
        d = F.max_pool2d(self.conv2(d), 2, 2)

        def rows(t):
            return t.flatten(2).transpose(1, 2)

        q = rows(self.query_conv(cross))
        k = rows(self.key_conv(front))
        v = rows(self.value_conv(front_hat))
        energy = bmm(k, q.transpose(1, 2))
        score, idx = energy.max(1)
        t = torch.gather(v, 1, idx[..., None].expand(-1, -1, c))
        t = t.transpose(1, 2).reshape(b, c, h, w)
        s_map = score.reshape(b, 1, h, w)
        out = front + self.f_conv(torch.cat([front, t], 1)) * s_map
        qd = rows(self.query_conv_depth(cross))
        kd = rows(self.key_conv_depth(front))
        vd = self.value_conv_depth(d)
        attn = bmm(kd, qd.transpose(1, 2)).amax(1).reshape(b, 1, h, w)
        return out + product(torch.matmul(operand(attn, False), operand(vd, False)), False), s_map, attn


class LayoutDecoder(nn.Module):
    def __init__(self, num_class=2, c=128):
        super().__init__()
        layers = []
        for ch in (256, 128, 64, 32, 16):
            layers += [Conv2d(c, ch, 3, 1, 1), BatchNorm2d(ch), nn.ReLU(),
                       Conv2d(ch, ch, 3, 1, 1), BatchNorm2d(ch)]
            c = ch
        layers.append(ConvReflect3x3(c, num_class))
        self.decoder = nn.ModuleList(layers)

    def forward(self, x):
        dec = self.decoder
        for base in range(0, 25, 5):
            x = F.relu(dec[base + 1](dec[base](x)))
            x = dec[base + 4](dec[base + 3](upsample2x(x)))
        return dec[25](x)


def rot_from_axisangle(vec):
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca, sa = torch.cos(angle)[..., 0], torch.sin(angle)[..., 0]
    c1 = 1.0 - ca
    x, y, z = axis.unbind(-1)
    rot = torch.stack([
        x * x * c1 + ca, x * y * c1 - z * sa, z * x * c1 + y * sa,
        x * y * c1 + z * sa, y * y * c1 + ca, y * z * c1 - x * sa,
        z * x * c1 - y * sa, y * z * c1 + x * sa, z * z * c1 + ca], -1).reshape(-1, 3, 3)
    out = torch.zeros(vec.shape[0], 4, 4, dtype=vec.dtype, device=vec.device)
    out[:, :3, :3] = rot
    out[:, 3, 3] = 1.0
    return out


def transformation_from_parameters(axisangle, translation, invert=False):
    """SE3 of (axis-angle, translation): T @ R, or R^T @ T(-t) inverted."""
    r = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        r, t = r.transpose(1, 2), -t
    tm = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    tm[:, :3, 3] = t
    return r @ tm if invert else tm @ r


class ReferenceModel(nn.Module):
    """The JPerceiver forward: `branches` "road" or "both"; the ResNet
    depths of the depth and layout trunks (`depth_layers`) and of the pose
    trunk (`pose_layers`); outputs fp32 under the model's keys. `remat`
    checkpoints the trunks in training (the same function, less memory)."""

    def __init__(self, occ_map_size=256, branches="both", frame_ids=(0, -1, 1), remat=False,
                 depth_layers=18, pose_layers=18):
        super().__init__()
        self.frame_ids = tuple(frame_ids)
        self.branches = branches
        self.remat = remat
        self.DepthEncoder = DepthEncoder(depth_layers)
        self.DepthDecoder = DepthDecoder(depth_layers)
        self.PoseEncoder = PoseEncoder(pose_layers)
        self.PoseDecoder = PoseDecoder(pose_layers)
        self.LayoutEncoder = LayoutEncoder(depth_layers)
        self.suffixes = {"road": ("",), "both": ("", "B")}[branches]
        for s in self.suffixes:
            self.add_module(f"CycledViewProjection{s}", CycledViewProjection(occ_map_size // 32))
            self.add_module(f"CrossViewTransformer{s}",
                            CrossViewTransformer(depth_channels=pyramid(depth_layers)[-1]))
            self.add_module(f"LayoutDecoder{s}", LayoutDecoder())
            self.add_module(f"LayoutTransformDecoder{s}", LayoutDecoder())

    def _trunk(self, fn, *args):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def pose(self, a, b):
        """(axisangle, translation) of the pair (a, b), each (B, 3, H, W)."""
        ph, pw = POSE_INPUT_HW
        pair = torch.cat([resize_bilinear(a, ph, pw), resize_bilinear(b, ph, pw)], 1)
        return self.PoseDecoder(self._trunk(self.PoseEncoder, pair))

    def forward(self, color_aug, with_pose=True, generator=None):
        """color_aug (B, F, 3, H, W). In training the depth decoder's l4
        and l3 features are dropped at rate 0.5, their masks drawn from
        `generator` in that order; the layout branches read l4 undropped."""
        img = color_aug[:, 0]
        feats = self._trunk(self.DepthEncoder, img)
        dropped = list(feats)
        if self.training:
            for i in (4, 3):
                keep = torch.rand(feats[i].shape, generator=generator,
                                  device=feats[i].device) < 0.5
                dropped[i] = torch.where(keep, feats[i] / 0.5, 0)
        out = dict(self._trunk(self.DepthDecoder, dropped))
        enc = self._trunk(self.LayoutEncoder, img)
        for s in self.suffixes:
            transform, retransform = getattr(self, f"CycledViewProjection{s}")(enc)
            fused, score, attn = getattr(self, f"CrossViewTransformer{s}")(
                enc, transform, retransform, feats[-1])
            out[f"topview{s}"] = self._trunk(getattr(self, f"LayoutDecoder{s}"), fused)
            out[f"transform_topview{s}"] = self._trunk(
                getattr(self, f"LayoutTransformDecoder{s}"), transform)
            out[f"features{s}"] = fused
            out[f"retransform_features{s}"] = retransform
            out[f"cv_attn{s}"] = score
            out[f"cm_attn{s}"] = attn
        if with_pose:
            for i, f in enumerate(self.frame_ids[1:], start=1):
                pair = (color_aug[:, i], img) if f < 0 else (img, color_aug[:, i])
                axisangle, translation = self.pose(*pair)
                out[f"cam_T_cam/{f}"] = transformation_from_parameters(
                    axisangle, translation, invert=f < 0)
        return out
