"""Shared conv blocks (counterpart of `jperceiver_tpu/models/common.py`).

Modules are NCHW. Parameters stay fp32 and are cast to the module's compute
dtype where they are used, as in the JAX modules; outputs are in the compute
dtype. Parameter names follow the reference `Baseline` state-dict keys.

The JAX package's TPU lowerings of these blocks (nine-dot convs, folded
upsample convs, the split iconv, the decomposed disp head) compute the same
functions as the plain forms here.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda import conv3x3_fwd, maxpool5x5_fwd, maxpool5x5_plain
from ..ops.cuda.conv3x3 import conv_site_eligible
from ..ops.padding import reflect_pad


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
    kernel K3.

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
                conv3x3_deep: bool = True, maxpool5x5: bool = True) -> None:
    """Route `model`'s sites to the hand-written kernels or away from them:
    K3's two gates (`use_pallas_conv`, `use_pallas_conv_deep`) on every
    `Conv3x3`, and K5 (else its plain version) in every `CRPBlock`."""
    for m in model.modules():
        if isinstance(m, Conv3x3):
            m.gate_shallow, m.gate_deep = bool(conv3x3_shallow), bool(conv3x3_deep)
        elif isinstance(m, CRPBlock):
            m.use_kernel = bool(maxpool5x5)


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
    """Chained residual pooling: n stages of 5x5/s1 max-pool (kernel K5) ->
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
        pool = maxpool5x5_fwd if self.use_kernel else maxpool5x5_plain
        top = x
        for i in range(1, self.n_stages + 1):
            top = pool(top)
            top = getattr(self, f"{i}_pointwise")(top)
            x = top + x
        return x
