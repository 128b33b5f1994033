"""Max-pools with the JAX package's equality-mask backward: the 5x5
stride-1 SAME pool of the CRP blocks, whose forward is kernel K5, and the
3x3 stride-2 stem pool.

Counterpart of `jperceiver_tpu/ops/pallas/maxpool.py` (`pallas_fwd`,
`max_pool_5x5_s1`, `max_pool_3x3_s2`). Out-of-image positions count as
-inf. K5 is `csrc/maxpool5x5.cu`; it reads channels-last memory, so the
wrapper takes an NCHW tensor in channels-last memory format as it is and
returns its output in that format. A max is exact, so the kernel and the
plain version agree bit for bit.

Both backwards route the cotangent as JAX's `_mp_bwd` / `_mp3_bwd` do
(`maxpool.py:64-104,157-172`): to EVERY input equal to the max of a window
that holds it, where `F.max_pool2d`'s backward picks one. Ties are common
on post-ReLU zeros and in bf16. The backwards are plain PyTorch (on the
TPU they are XLA, not Pallas) and are the same whether the forward ran K5
or its plain version, so the two routings differ only by the kernel.

`maxpool5x5_fwd` launches K5 for a CUDA tensor and takes the plain version
only for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# Launches of the kernel (not of the plain version) in this process.
LAUNCHES = {"maxpool5x5": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _axis_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """5-tap stride-1 SAME max along one spatial dim (2 = H, 3 = W)."""
    pad = (2, 2, 0, 0) if dim == 3 else (0, 0, 2, 2)
    xp = F.pad(x, pad, value=float("-inf"))
    n = x.shape[dim]
    acc = x
    for d in (0, 1, 3, 4):
        acc = torch.maximum(acc, xp.narrow(dim, d, n))
    return acc


def _axis_route(x, y, g, dim: int) -> torch.Tensor:
    """`_axis_route`: dx[i] = sum over windows j holding i of g[j] where
    x[i] == y[j], along one spatial dim, summed in window order."""
    pad = (2, 2, 0, 0) if dim == 3 else (0, 0, 2, 2)
    yp = F.pad(y, pad, value=float("-inf"))
    gp = F.pad(g, pad)
    n = x.shape[dim]
    acc = torch.zeros_like(x)
    for d in range(5):
        acc = acc + torch.where(x == yp.narrow(dim, d, n), gp.narrow(dim, d, n), 0)
    return acc


def maxpool5x5_plain(x: torch.Tensor) -> torch.Tensor:
    """The separable form of `maxpool.py:51-91`: along W, then along H."""
    return _axis_max(_axis_max(x, 3), 2)


def _pool5(x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    if not (use_kernel and x.is_cuda):
        return maxpool5x5_plain(x)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"maxpool5x5_fwd: dtype {x.dtype} is not bf16 or fp32")
    bsz, c, h, w = x.shape
    xh = x.permute(0, 2, 3, 1).contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if xh.data_ptr() % 16:
        raise ValueError("maxpool5x5_fwd: input is not 16-byte aligned")
    err = _build.library().jp_maxpool5x5_fwd(
        xh.data_ptr(), y.data_ptr(), bsz, h, w, c, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "maxpool5x5_fwd")
    LAUNCHES["maxpool5x5"] += 1
    return y


class _MaxPool5x5(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, use_kernel):
        y = _pool5(x, use_kernel)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        r = _axis_max(x, 3)  # the forward's first stage, recomputed
        dr = _axis_route(r, y, g.to(x.dtype), 2)
        return _axis_route(x, r, dr, 3), None


def maxpool5x5(x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """5x5 stride-1 SAME max-pool of x (B, C, H, W), -inf padding, with the
    equality-mask backward; the forward is K5 on a CUDA tensor when
    `use_kernel`, else the plain version."""
    if x.dim() != 4:
        raise ValueError(f"maxpool5x5: x must be 4-D, got {tuple(x.shape)}")
    return _MaxPool5x5.apply(x, use_kernel)


def maxpool5x5_fwd(x: torch.Tensor) -> torch.Tensor:
    """`maxpool5x5` with the kernel on."""
    return maxpool5x5(x, True)


def _dilate2(t: torch.Tensor, fill: float, h: int, w: int) -> torch.Tensor:
    """`_dilate2`: out[2j + 1] = t[j], `fill` elsewhere, on an (h+2, w+2)
    grid, so window j's entry sits at input i + d, d in {0, 1, 2}."""
    out = t.new_full((t.shape[0], t.shape[1], h + 2, w + 2), fill)
    out[:, :, 1:2 * t.shape[2]:2, 1:2 * t.shape[3]:2] = t
    return out


class _MaxPool3x3s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 3, 2, 1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        h, w = x.shape[2], x.shape[3]
        yd = _dilate2(y, float("-inf"), h, w)
        gd = _dilate2(g.to(x.dtype), 0.0, h, w)
        acc = torch.zeros_like(x)
        for dy in range(3):
            for dx in range(3):
                yj = yd[:, :, dy:dy + h, dx:dx + w]
                acc = acc + torch.where(x == yj, gd[:, :, dy:dy + h, dx:dx + w], 0)
        return acc


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 SAME max-pool of x (B, C, H, W), -inf padding, with the
    equality-mask backward of `max_pool_3x3_s2`."""
    return _MaxPool3x3s2.apply(x)
