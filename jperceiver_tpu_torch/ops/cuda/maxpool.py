"""Max-pools with the JAX package's equality-mask backward: the 5x5
stride-1 SAME pool of the CRP blocks, whose forward is kernel K5 and whose
backward is the kernel `maxpool5x5_bwd`, and the 3x3 stride-2 stem pool,
whose forward is `F.max_pool2d` and whose backward is the kernel
`maxpool3x3s2_bwd`.

Counterpart of `jperceiver_tpu/ops/pallas/maxpool.py` (`pallas_fwd`,
`max_pool_5x5_s1`, `max_pool_3x3_s2`). Out-of-image positions count as
-inf. The CRP kernels are `csrc/maxpool5x5.cu`, the stem pool's
`csrc/maxpool3x3s2.cu`; they read channels-last memory, so the wrappers
take NCHW tensors in channels-last memory format as they are and return
channels-last outputs. `k5_plan` picks the CRP kernels' tiles; the CPU
tests replay it and the stem kernel's window walk.

Both backwards route the cotangent as JAX's `_mp_bwd` / `_mp3_bwd` do
(`maxpool.py:64-104,157-172`): to EVERY input equal to the max of a window
that holds it, where `F.max_pool2d`'s backward picks one. Ties are common
on post-ReLU zeros and in bf16. The CRP backward is the separable
`dx = route_W(x, r, route_H(r, y, g))`, r the forward's W stage recomputed,
each route's five additions rounded to the dtype in window order: the
kernel and the plain version agree bit for bit, as the forwards do (a max
is exact). The stem backward adds the terms of the windows that hold an
input in the plain version's order, rounded to the dtype: bit for bit too.

`maxpool5x5(x, use_kernel)` and `maxpool3x3s2(x, use_kernel)` launch the
kernels for a CUDA tensor when `use_kernel`, and take the plain versions
for a CPU tensor or `use_kernel=False`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build
from .conv3x3 import _sm_count

# Launches of the kernels (not of the plain versions) in this process, and
# the cotangents the backwards had to copy into channels-last memory first.
LAUNCHES = {"maxpool5x5": 0, "maxpool5x5_bwd": 0, "maxpool5x5_bwd_cot_copy": 0,
            "maxpool3x3s2_bwd": 0, "maxpool3x3s2_bwd_cot_copy": 0}

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


def maxpool5x5_bwd_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """`_mp_bwd`: the cotangent g of y = maxpool5x5(x) routed onto x."""
    r = _axis_max(x, 3)  # the forward's first stage, recomputed
    dr = _axis_route(r, y, g.to(x.dtype), 2)
    return _axis_route(x, r, dr, 3)


@dataclass(frozen=True)
class PoolPlan:
    """A K5 launch: channels in vectors of `vec` (16 bytes, or 1 where C is
    not a multiple of 16 bytes), `cv` vectors a pixel; a block owns `th`
    output rows x `tw` columns x `cb` vectors of one image."""

    b: int
    h: int
    w: int
    vec: int
    cv: int
    th: int
    tw: int
    cb: int

    @property
    def grid(self) -> tuple[int, int, int]:
        """(channel tiles x column tiles, row tiles, images), as the kernels
        read blockIdx."""
        return (_ceil(self.cv, self.cb) * _ceil(self.w, self.tw), _ceil(self.h, self.th), self.b)

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def tile(self, block: int) -> tuple[int, int, int, int]:
        """(image, first row, first column, first vector) of a block, for
        block = bx + grid_x * (by + grid_y * bz)."""
        gx, gy, _ = self.grid
        bx, by, bz = block % gx, (block // gx) % gy, block // (gx * gy)
        tiles_c = _ceil(self.cv, self.cb)
        return bz, by * self.th, (bx // tiles_c) * self.tw, (bx % tiles_c) * self.cb


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _vec(c: int, item: int) -> int:
    """Channels a vector: 16 bytes, or 1 where C is not a multiple of them."""
    return 16 // item if c % (16 // item) == 0 else 1


# Rows a block: the largest that still gives 4 blocks a SM, the backward's
# at most 8 (it stages x, y and g).
_TH_FWD, _TH_BWD = (16, 8, 4, 2, 1), (8, 4, 2, 1)


def k5_plan(b: int, h: int, w: int, c: int, item: int, sms: int,
            backward: bool = False) -> PoolPlan:
    """The tiles of a K5 launch (forward, or the backward when `backward`)
    over (b, h, w, c) channels-last elements of `item` bytes on `sms` SMs.
    32 columns x 4 vectors a block (64 contiguous bytes a pixel, whole
    32-byte sectors); at the 32^2 and 64^2 CRP pools the rows a block
    shrink until the grid fills the card."""
    vec = _vec(c, item)
    cv = c // vec
    cb = min(4, cv)
    tw = 32 if w > 16 else (16 if w > 8 else 8)
    for th in _TH_BWD if backward else _TH_FWD:
        plan = PoolPlan(b, h, w, vec, cv, th, tw, cb)
        if plan.blocks >= 4 * sms:
            break
    return plan


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) memory of an NCHW tensor: a view when t is channels-last."""
    return t.permute(0, 2, 3, 1).contiguous()


def _launch(fn, counter: str, out: torch.Tensor, *tensors: torch.Tensor,
            backward: bool = False) -> torch.Tensor:
    x = tensors[0]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{counter}: dtype {x.dtype} is not bf16 or fp32")
    bsz, c, h, w = x.shape
    plan = k5_plan(bsz, h, w, c, x.element_size(), _sm_count(x.device.index or 0), backward)
    held = [_channels_last(t) for t in tensors]  # alive until the launch is queued
    ptrs = [t.data_ptr() for t in held] + [out.data_ptr()]
    if plan.vec > 1 and any(p % 16 for p in ptrs):
        raise ValueError(f"{counter}: operands are not 16-byte aligned")
    err = fn(*ptrs, bsz, h, w, c, _DTYPE_CODE[x.dtype], plan.vec, plan.th, plan.tw, plan.cb,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, counter)
    LAUNCHES[counter] += 1
    return out


def maxpool5x5_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The equality-mask backward of y = maxpool5x5(x) for the cotangent g,
    in x's dtype and channels-last memory: the kernel for CUDA tensors, the
    plain version for CPU tensors. g may come in any memory format; one that
    is not channels-last is copied first, and counted."""
    if not x.is_cuda:
        return maxpool5x5_bwd_plain(x, y, g)
    g = g.to(x.dtype)
    if not g.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
        LAUNCHES["maxpool5x5_bwd_cot_copy"] += 1
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    return _launch(_build.library().jp_maxpool5x5_bwd, "maxpool5x5_bwd", dx, x, y, g,
                   backward=True)


def _pool5(x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    if not (use_kernel and x.is_cuda):
        return maxpool5x5_plain(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    return _launch(_build.library().jp_maxpool5x5_fwd, "maxpool5x5", y, x)


class _MaxPool5x5(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, use_kernel):
        y = _pool5(x, use_kernel)
        ctx.save_for_backward(x, y)
        ctx.use_kernel = use_kernel
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if ctx.use_kernel:
            return maxpool5x5_bwd(x, y, g), None
        return maxpool5x5_bwd_plain(x, y, g), None


def maxpool5x5(x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """5x5 stride-1 SAME max-pool of x (B, C, H, W), -inf padding, with the
    equality-mask backward; on a CUDA tensor with `use_kernel` the forward
    is K5 and the backward `maxpool5x5_bwd`, else the plain versions."""
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


def maxpool3x3s2_bwd_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """`_mp3_bwd`: the cotangent g of y = maxpool3x3s2(x) routed onto x,
    nine shifted compares over the stride-2 dilated grid."""
    h, w = x.shape[2], x.shape[3]
    yd = _dilate2(y, float("-inf"), h, w)
    gd = _dilate2(g.to(x.dtype), 0.0, h, w)
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            yj = yd[:, :, dy:dy + h, dx:dx + w]
            acc = acc + torch.where(x == yj, gd[:, :, dy:dy + h, dx:dx + w], 0)
    return acc


def maxpool3x3s2_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The equality-mask backward of y = maxpool3x3s2(x) for the cotangent
    g, in x's dtype and channels-last memory: the kernel for CUDA tensors,
    the plain version for CPU tensors. g may come in any memory format; one
    that is not channels-last is copied first, and counted."""
    if not x.is_cuda:
        return maxpool3x3s2_bwd_plain(x, y, g)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"maxpool3x3s2_bwd: dtype {x.dtype} is not bf16 or fp32")
    bsz, c, h, w = x.shape
    if tuple(y.shape) != (bsz, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1) or g.shape != y.shape:
        raise ValueError(f"maxpool3x3s2_bwd: y {tuple(y.shape)}, g {tuple(g.shape)} "
                         f"are not the pool of x {tuple(x.shape)}")
    g = g.to(x.dtype)
    if not g.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
        LAUNCHES["maxpool3x3s2_bwd_cot_copy"] += 1
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    vec = _vec(c, x.element_size())
    held = [_channels_last(t) for t in (x, y, g)]  # alive until the launch is queued
    ptrs = [t.data_ptr() for t in held] + [dx.data_ptr()]
    if vec > 1 and any(p % 16 for p in ptrs):
        raise ValueError("maxpool3x3s2_bwd: operands are not 16-byte aligned")
    err = _build.library().jp_maxpool3x3s2_bwd(
        *ptrs, bsz, h, w, c, _DTYPE_CODE[x.dtype], vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "maxpool3x3s2_bwd")
    LAUNCHES["maxpool3x3s2_bwd"] += 1
    return dx


class _MaxPool3x3s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, use_kernel):
        y = F.max_pool2d(x, 3, 2, 1)
        ctx.save_for_backward(x, y)
        ctx.use_kernel = use_kernel
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if ctx.use_kernel:
            return maxpool3x3s2_bwd(x, y, g), None
        return maxpool3x3s2_bwd_plain(x, y, g), None


def maxpool3x3s2(x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """3x3 stride-2 SAME max-pool of x (B, C, H, W), -inf padding, with the
    equality-mask backward of `max_pool_3x3_s2`; on a CUDA tensor with
    `use_kernel` the backward is `maxpool3x3s2_bwd`, else the plain
    version."""
    if x.dim() != 4:
        raise ValueError(f"maxpool3x3s2: x must be 4-D, got {tuple(x.shape)}")
    return _MaxPool3x3s2.apply(x, use_kernel)
