"""Fused photometric reprojection loss with frame-min: kernels K1 (forward)
and K2 (backward), their plain versions, and the differentiable
`reproj_min`.

Counterpart of `jperceiver_tpu/ops/pallas/reproj.py::reproj_min_pallas`
(a `custom_vjp` over `_fwd_kernel` and `_bwd_kernel` with XLA-side ring
fix-ups). The kernels are `csrc/reproj.cu`; see there for the function,
the tie and clip rules of the backward, the design and the bound. K1 also
writes, when the preds need a gradient, a routing code per pixel (two bits
a link of the frame-min chain: greater, less or equal), which
`_ReprojMin` saves for K2, so the backward routes as the forward decided.

Contract: preds (S, B, F, C, H, W) and the target (B, C, H, W), both bf16
or both fp32, channel-planar; fp32 statistics; the output (S, B, H, W)
fp32 is the min over frames (a chain of minimums) of the channel-mean
`0.85 * clip((1 - SSIM) / 2) + 0.15 * sqrt(d^2 + 1e-6)`. The backward
returns the preds' gradient in their dtype and gives the target none: in
every call site it is input data.

`reproj_min` launches the kernels for CUDA tensors and takes the plain
versions only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..photometric import reprojection_loss
from . import _build

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


def _fwd(preds, targ, route=False):
    """K1 (the plain version for CPU tensors): the loss and, when `route`,
    K1's routing code for K2 (None on the CPU)."""
    if not preds.is_cuda:
        return reproj_min_plain(preds, targ), None
    preds, targ = preds.contiguous(), targ.contiguous()
    s, b, f, c, h, w = preds.shape
    out = torch.empty((s, b, h, w), device=preds.device, dtype=torch.float32)
    # uint16 codes, held as int16 (the bits are what K2 reads).
    code = torch.empty((s, b, h, w), device=preds.device, dtype=torch.int16) if route else None
    err = _build.library().jp_reproj_fwd(
        preds.data_ptr(), targ.data_ptr(), out.data_ptr(),
        None if code is None else code.data_ptr(), s, b, f, c, h, w,
        _DTYPE_CODE[preds.dtype], torch.cuda.current_stream(preds.device).cuda_stream)
    _build.check(err, "reproj_fwd")
    LAUNCHES["reproj_fwd"] += 1
    return out, code


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
    @staticmethod
    def forward(ctx, preds, targ, route):
        out, code = _fwd(preds, targ, route)
        ctx.save_for_backward(preds, targ, code)
        return out

    @staticmethod
    def backward(ctx, cot):
        preds, targ, code = ctx.saved_tensors
        dp = _bwd(preds, targ, cot, code) if ctx.needs_input_grad[0] else None
        dt = torch.zeros_like(targ) if ctx.needs_input_grad[1] else None
        return dp, dt, None


def reproj_min(preds: torch.Tensor, targ: torch.Tensor) -> torch.Tensor:
    """min over frames of the reprojection loss: preds (S, B, F, C, H, W),
    targ (B, C, H, W) -> (S, B, H, W) fp32, differentiable in preds."""
    _check(preds, targ)
    # K1 writes the routing code only where the preds will get a gradient:
    # the automask identity pairs run under no_grad.
    route = preds.requires_grad and torch.is_grad_enabled()
    return _ReprojMin.apply(preds, targ, route)
