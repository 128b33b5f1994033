"""Shared conv blocks (counterpart of `jperceiver_tpu/models/common.py`).

Modules are NCHW. Parameters stay fp32 and are cast to the module's compute
dtype where they are used, as in the JAX modules; outputs are in the compute
dtype. Parameter names follow the reference `Baseline` state-dict keys.

The JAX package's TPU lowerings of these blocks (nine-dot convs, folded
upsample convs, the split iconv, the decomposed disp head) compute the same
functions as the plain forms here.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel as dist
from ..ops.cuda import conv3x3_fwd, maxpool5x5
from ..ops.cuda.conv3x3 import conv_site_eligible
from ..ops.padding import reflect_pad


class BatchNorm2d(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` semantics under the
    `nn.BatchNorm2d` state-dict keys.

    Statistics are at least fp32 whatever the input dtype. In training, the batch
    mean and the BIASED batch variance (E[x^2] - E[x]^2, clamped at 0)
    normalize the input and update the running statistics with torch
    momentum 0.1 (flax 0.9); in eval the running statistics normalize it.
    Either way y = (x - mean) * (rsqrt(var + eps) * scale) + bias in fp32,
    returned in the input dtype. While `update_stats` is False (a
    recompute of a checkpointed trunk, `frozen_running_stats`), training
    normalizes by the batch statistics and leaves the running ones as they
    are.

    The batch is the global one, as the JAX package's BatchNorm takes it
    over the sharded array. `groups` (`set_bn_groups`, the JAX package's
    `per_replica_bn`) splits it:
      - one process, G groups: statistics per contiguous block of B/G
        samples; the running statistics update with their average over
        the groups;
      - under a process group, `groups` 1: E[x] and E[x^2] are the
        all-reduced means of the ranks' (with a gradient), so every rank
        normalizes by the statistics of the global batch;
      - under a process group, `groups` equal to the world size: each rank
        normalizes by its own batch (the reference's per-GPU BN under DDP);
        the running statistics update with the ranks' average, all-reduced
        and detached, so they stay equal on every rank.
    """

    update_stats = True
    groups = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return self._normalize(xf, self.running_mean, self.running_var).to(x.dtype)
        distributed = dist.is_distributed()
        if self.groups > 1 and not distributed:
            return self._grouped(xf).to(x.dtype)
        if distributed and self.groups == 1:
            # E[x] and E[x^2] of the global batch, with a gradient.
            stats = torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
            mean, mean_sq = dist.all_reduce_sum(stats) / dist.world_size()
            var = torch.maximum(mean_sq - mean * mean, mean.new_zeros(()))
        else:
            mean, var = self._moments(xf)
        if self.update_stats:
            running = torch.stack([mean, var]).detach()
            if distributed and self.groups > 1:  # each rank's own: their average
                running = dist.all_reduce_mean(running)
            self._update_running(running[0], running[1])
        return self._normalize(xf, mean, var).to(x.dtype)

    def _grouped(self, xf: torch.Tensor) -> torch.Tensor:
        """One process, `groups` contiguous blocks of the batch, each
        normalized by its own moments; the running statistics update with
        the blocks' average."""
        g = self.groups
        if xf.shape[0] % g:
            raise ValueError(f"BatchNorm2d: batch {xf.shape[0]} not divisible by {g} groups")
        xg = xf.reshape(g, xf.shape[0] // g, *xf.shape[1:])
        mean, var = self._moments(xg, (1, 3, 4))
        if self.update_stats:
            self._update_running(mean.detach().mean(0), var.detach().mean(0))
        return self._normalize(xg, mean[:, None], var[:, None]).reshape(xf.shape)

    @staticmethod
    def _moments(xf: torch.Tensor, dims=(0, 2, 3)):
        mean = xf.mean(dims)
        var = torch.maximum((xf * xf).mean(dims) - mean * mean, mean.new_zeros(()))
        return mean, var

    def _normalize(self, xf, mean, var):
        """(x - mean) * (rsqrt(var + eps) * scale) + bias; `mean` and `var`
        are (..., C) and broadcast over the trailing (C, H, W)."""
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[..., None, None]) * mul[..., None, None] + self.bias[:, None, None]

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)


def set_bn_groups(model: nn.Module, groups: int) -> None:
    """`cfg.bn_groups` (the JAX package's `per_replica_bn`) on every
    `BatchNorm2d` of `model`: 1, the statistics of the global batch, or G
    groups. Under a process group G must be 1 or the world size (each
    rank's own batch); any other count raises."""
    groups = int(groups)
    w = dist.world_size()
    if groups < 1 or (dist.is_distributed() and groups not in (1, w)):
        raise ValueError(f"bn_groups {groups}: under {w} rank(s) it must be 1 or {w}"
                         if dist.is_distributed() else f"bn_groups {groups} must be >= 1")
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.groups = groups


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Every `BatchNorm2d` of `module` leaves its running statistics as
    they are inside the block."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            del m.update_stats


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the draw comes from `generator`. Under a
    process group the mask is drawn for the global batch and this rank
    keeps its rows, as JAX draws one key over the global array."""
    keep = 1.0 - rate
    mask = dist.rank_rows(lambda shape: torch.rand(shape, generator=generator,
                                                   device=x.device), x.shape) < keep
    return torch.where(mask, x / keep, 0)


class CastConv2d(nn.Conv2d):
    """`nn.Conv2d` whose operands are cast to `dtype` at use (flax
    `nn.Conv(dtype=...)`): the output and the bias add are in `dtype`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding)


class CastLinear(nn.Linear):
    """`nn.Linear` computed in `dtype` (flax `nn.Dense(dtype=...)`)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv3x3(CastConv2d):
    """3x3 conv, `mode` "same" (zero pad 1) or "valid" (input pre-padded by
    the caller), that sends eligible stride-1 sites on a CUDA tensor to
    kernel K3 (and their backward to K3 as the data-grad and K4).

    A site is eligible when one of the two gates passes on its output
    extent (`ops/cuda/conv3x3.py::conv_site_eligible`); `set_kernels`
    turns the gates on and off for a whole model. Elsewhere the conv runs
    in the compute dtype through `F.conv2d`.
    """

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 bias: bool = True, mode: str = "same",
                 dtype: torch.dtype = torch.float32):
        if mode not in ("same", "valid"):
            raise ValueError(f"Conv3x3: mode must be same or valid, got {mode}")
        super().__init__(c_in, c_out, 3, stride=stride,
                         padding=1 if mode == "same" else 0, bias=bias,
                         dtype=dtype)
        self.gate_shallow = True
        self.gate_deep = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == (1, 1) and x.is_cuda:
            pad = self.padding[0]
            h, w = x.shape[2] + 2 * pad - 2, x.shape[3] + 2 * pad - 2
            if conv_site_eligible(self.in_channels, self.out_channels, h, w,
                                  self.gate_shallow, self.gate_deep):
                dt = self.compute_dtype
                b = None if self.bias is None else self.bias.to(dt)
                return conv3x3_fwd(x.to(dt), self.weight.to(dt), b, pad)
        return super().forward(x)


def set_kernels(model: nn.Module, conv3x3_shallow: bool = True,
                conv3x3_deep: bool = True, maxpool5x5: bool = True, *,
                stem_pool: bool = True) -> None:
    """Route `model`'s sites to the hand-written kernels or away from them:
    K3's two gates (`use_pallas_conv`, `use_pallas_conv_deep`) on every
    `Conv3x3`, K5 and its backward kernel (else their plain versions) in
    every `CRPBlock`, and the stem pool's backward kernel (else its plain
    version) in every `ResNet`."""
    from .resnet import ResNet

    for m in model.modules():
        if isinstance(m, Conv3x3):
            m.gate_shallow, m.gate_deep = bool(conv3x3_shallow), bool(conv3x3_deep)
        elif isinstance(m, CRPBlock):
            m.use_kernel = bool(maxpool5x5)
        elif isinstance(m, ResNet):
            m.use_kernel = bool(stem_pool)


def kernel_gates(model: nn.Module):
    """A reader of `model`'s routing to the kernels, what `set_kernels`
    sets, and of `torch.backends.cudnn.allow_tf32`, which routes K3's
    float32 calls (and cuDNN's) to TF32: a captured graph keeps the routing
    it was captured with, so the routing is part of its key."""
    from .resnet import ResNet

    convs = [m for m in model.modules() if isinstance(m, Conv3x3)]
    pools = [m for m in model.modules() if isinstance(m, (CRPBlock, ResNet))]
    return lambda: (tuple((m.gate_shallow, m.gate_deep) for m in convs),
                    tuple(m.use_kernel for m in pools), torch.backends.cudnn.allow_tf32)


class ConvReflect3x3(nn.Module):
    """ReflectionPad(1) + 3x3 VALID conv (the reference's `Conv3x3`)."""

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3x3(c_in, c_out, mode="valid", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad(x))


class Conv1x1(nn.Module):
    def __init__(self, c_in: int, c_out: int, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = CastConv2d(c_in, c_out, 1, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class CRPBlock(nn.Module):
    """Chained residual pooling: n stages of 5x5/s1 max-pool (kernel K5,
    else its plain version; the equality-mask backward either way) ->
    1x1 conv, summed into the trunk."""

    def __init__(self, features: int, n_stages: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_stages = n_stages
        self.use_kernel = True
        for i in range(1, n_stages + 1):
            self.add_module(f"{i}_pointwise",
                            Conv1x1(features, features, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top = x
        for i in range(1, self.n_stages + 1):
            top = maxpool5x5(top, self.use_kernel)
            top = getattr(self, f"{i}_pointwise")(top)
            x = top + x
        return x
