"""Fused photometric reprojection loss with frame-min: kernels K1 (forward)
and K2 (backward), their plain versions, and the differentiable
`reproj_min` and `reproj_min_automask`.

Counterpart of `jperceiver_tpu/ops/pallas/reproj.py::reproj_min_pallas`
(a `custom_vjp` over `_fwd_kernel` and `_bwd_kernel` with XLA-side ring
fix-ups). The kernels are `csrc/reproj.cu`; see there for the function,
the tie and clip rules of the backward, the design and the bound. K1 also
writes, when the preds need a gradient, a routing code per pixel (two bits
a link of the frame-min chain: greater, less or equal), which
`_ReprojMin` saves for K2, so the backward routes as the forward decided.
`k1_plan` picks K1's tiles; the CPU tests replay it.

Contract: preds (S, B, F, C, H, W) and the target (B, C, H, W), both bf16
or both fp32, channel-planar; fp32 statistics; the output (S, B, H, W)
fp32 is the min over frames (a chain of minimums) of the channel-mean
`0.85 * clip((1 - SSIM) / 2) + 0.15 * sqrt(d^2 + 1e-6)`. The backward
returns the preds' gradient in their dtype and gives the target none: in
every call site it is input data. `reproj_min_automask` adds identity
frames (F', B, C, H, W) against the same target, whose losses
(F', B, H, W) come out of the same K1 launch with no gradient.

Both entries launch the kernels for CUDA tensors and take the plain
versions only for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..photometric import reprojection_loss
from . import _build
from .conv3x3 import _sm_count

# Launches of the kernels (not of the plain versions) in this process.
LAUNCHES = {"reproj_fwd": 0, "reproj_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reproj_min_plain(preds: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
    """`reproj_min_reference` in fp32 (float64 for float64 operands): the
    photometric chain on the upcast operands, then the chain of minimums
    over frames."""
    dt = torch.promote_types(preds.dtype, torch.float32)
    rl = reprojection_loss(preds.to(dt), targ.to(dt)[:, None])[:, :, :, 0]
    best = rl[:, :, 0]
    for f in range(1, rl.shape[2]):
        best = torch.minimum(best, rl[:, :, f])
    return best


def _reproj_bwd_plain(preds, targ, cot):
    """Autograd of `reproj_min_plain`, in the preds' dtype."""
    with torch.enable_grad():
        p = preds.detach().to(torch.promote_types(preds.dtype, torch.float32))
        p.requires_grad_()
        (d,) = torch.autograd.grad(reproj_min_plain(p, targ), p, cot)
    return d.to(preds.dtype)


def _check(preds, targ):
    if preds.dim() != 6 or targ.dim() != 4:
        raise ValueError(f"reproj_min: preds {tuple(preds.shape)} must be "
                         f"(S, B, F, C, H, W), targ {tuple(targ.shape)} (B, C, H, W)")
    s, b, f, c, h, w = preds.shape
    if tuple(targ.shape) != (b, c, h, w):
        raise ValueError(f"reproj_min: targ {tuple(targ.shape)} does not match "
                         f"preds {tuple(preds.shape)}")
    # float64 runs the plain version on the CPU (a reference step); the
    # kernels take bf16 and fp32.
    allowed = _DTYPE_CODE if preds.is_cuda else (*_DTYPE_CODE, torch.float64)
    if preds.dtype != targ.dtype or preds.dtype not in allowed:
        raise TypeError(f"reproj_min: dtypes {preds.dtype}, {targ.dtype}; want "
                        "both bf16 or both fp32")
    if preds.device != targ.device:
        raise ValueError("reproj_min: preds and targ are on different devices")


@dataclass(frozen=True)
class K1Plan:
    """A K1 launch over b images of h x w: one block per image and tile of
    `tw` columns x `th` rows, `threads` threads (one column and 4 rows
    each)."""

    b: int
    h: int
    w: int
    th: int
    tw: int = 32

    @property
    def grid(self) -> tuple[int, int, int]:
        """(column tiles, row tiles, images), as the kernel reads blockIdx."""
        return (-(-self.w // self.tw), -(-self.h // self.th), self.b)

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def threads(self) -> int:
        return self.tw * self.th // 4

    def tile(self, block: int) -> tuple[int, int, int]:
        """(image, first row, first column) of block = bx + gx * (by + gy * bz)."""
        gx, gy, _ = self.grid
        return block // (gx * gy), (block // gx) % gy * self.th, block % gx * self.tw


def k1_plan(b: int, h: int, w: int, sms: int) -> K1Plan:
    """The tiles of a K1 launch over b images of h x w on `sms` SMs: the
    tallest tile (32, 16 or 8 rows; the halo is (th + 2) / th of the tile's
    rows) whose grid still gives 4 blocks a SM. At 1024^2 that is 32 rows,
    1,024 blocks a batch element."""
    for th in (32, 16, 8):
        plan = K1Plan(b, h, w, th)
        if plan.blocks >= 4 * sms:
            break
    return plan


def _fwd(preds, targ, route=False, ident=None):
    """K1 (the plain version for CPU tensors): the loss, K1's routing code
    for K2 when `route` (None on the CPU), and when `ident` (F', B, C, H, W)
    is given the identity frames' losses (F', B, H, W) from the same
    launch (else None)."""
    if not preds.is_cuda:
        ident_l = None if ident is None else reproj_min_plain(ident[:, :, None], targ)
        return reproj_min_plain(preds, targ), None, ident_l
    preds, targ = preds.contiguous(), targ.contiguous()
    s, b, f, c, h, w = preds.shape
    dev = preds.device
    out = torch.empty((s, b, h, w), device=dev, dtype=torch.float32)
    # uint16 codes, held as int16 (the bits are what K2 reads).
    code = torch.empty((s, b, h, w), device=dev, dtype=torch.int16) if route else None
    fi = 0 if ident is None else ident.shape[0]
    if fi:
        ident = ident.contiguous()
    ident_l = torch.empty((fi, b, h, w), device=dev, dtype=torch.float32) if fi else None
    plan = k1_plan(b, h, w, _sm_count(dev.index or 0))
    err = _build.library().jp_reproj_fwd(
        preds.data_ptr(), ident.data_ptr() if fi else None, targ.data_ptr(), out.data_ptr(),
        None if code is None else code.data_ptr(), ident_l.data_ptr() if fi else None,
        s, b, f, fi, c, h, w, plan.th, _DTYPE_CODE[preds.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "reproj_fwd")
    LAUNCHES["reproj_fwd"] += 1
    return out, code, ident_l


def _bwd(preds, targ, cot, code):
    """K2 (the plain version for CPU tensors): the preds' gradient for the
    cotangent, routed by K1's code."""
    if not preds.is_cuda:
        return _reproj_bwd_plain(preds, targ, cot)
    if code is None or tuple(code.shape) != tuple(cot.shape):
        raise ValueError("reproj_bwd: needs K1's routing code of the cotangent's shape")
    preds, targ = preds.contiguous(), targ.contiguous()
    cot = cot.float().contiguous()
    s, b, f, c, h, w = preds.shape
    grad = torch.empty(preds.shape, device=preds.device, dtype=preds.dtype)
    err = _build.library().jp_reproj_bwd(
        preds.data_ptr(), targ.data_ptr(), cot.data_ptr(), code.contiguous().data_ptr(),
        grad.data_ptr(), s, b, f, c, h, w, _DTYPE_CODE[preds.dtype],
        torch.cuda.current_stream(preds.device).cuda_stream)
    _build.check(err, "reproj_bwd")
    LAUNCHES["reproj_bwd"] += 1
    return grad


class _ReprojMin(torch.autograd.Function):
    """K1 forward (with the identity frames' losses when `ident` is given:
    a second output, not differentiable), K2 backward."""

    @staticmethod
    def forward(ctx, preds, targ, route, ident):
        out, code, ident_l = _fwd(preds, targ, route, ident)
        ctx.save_for_backward(preds, targ, code)
        if ident_l is None:
            return out
        ctx.mark_non_differentiable(ident_l)
        return out, ident_l

    @staticmethod
    def backward(ctx, cot, *_):
        preds, targ, code = ctx.saved_tensors
        dp = _bwd(preds, targ, cot, code) if ctx.needs_input_grad[0] else None
        dt = torch.zeros_like(targ) if ctx.needs_input_grad[1] else None
        return dp, dt, None, None


def _route(preds: torch.Tensor) -> bool:
    # K1 writes the routing code only where the preds will get a gradient.
    return preds.requires_grad and torch.is_grad_enabled()


def reproj_min(preds: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
    """min over frames of the reprojection loss: preds (S, B, F, C, H, W),
    targ (B, C, H, W) -> (S, B, H, W) fp32, differentiable in preds."""
    _check(preds, targ)
    return _ReprojMin.apply(preds, targ, _route(preds), None)


def reproj_min_automask(preds: torch.Tensor, ident: torch.Tensor,
                        targ: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`reproj_min(preds, targ)` and the automask identity losses
    `reproj_min(ident[:, :, None], targ)` (F', B, H, W) of the identity
    frames ident (F', B, C, H, W), in one K1 launch on the card. Only the
    first output is differentiable (in preds); the identity frames are
    input data."""
    _check(preds, targ)
    if ident.dim() != 5 or ident.shape[0] < 1:
        raise ValueError(f"reproj_min_automask: ident {tuple(ident.shape)} must be "
                         "(F', B, C, H, W) with F' >= 1")
    _check(ident[:, :, None], targ)
    return _ReprojMin.apply(preds, targ, _route(preds), ident.detach())
