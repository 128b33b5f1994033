"""3x3 stride-1 convolution: kernels K3 (forward and data-grad) and K4
(weight-grad), their plain versions, and the differentiable `conv3x3_fwd`.

Counterpart of `jperceiver_tpu/ops/pallas/conv3x3.py` (`pallas_conv3x3` for
pad 1, `pallas_conv3x3_valid` for pad 0, each a `custom_vjp`). The kernels
are `csrc/conv3x3.cu`, an implicit GEMM over channels-last tiles, and
`csrc/conv3x3_wgrad.cu`, a split-M GEMM with a deterministic reduction; see
there for their design and bound.

Contract: operands in their input dtype (bf16 or fp32), fp32 accumulation,
the bias added to the fp32 accumulator, the output in the input dtype.
Tensors are NCHW at this interface; the kernels read channels-last memory,
so the wrappers take an NCHW tensor in channels-last memory format as it is
and return outputs in that format.

The backward is the JAX `custom_vjp`'s (`conv3x3.py:237-248`): the
data-grad is K3 itself on the cotangent (cast to the input dtype) with the
flipped, transposed weights at pad `2 - pad`; the weight-grad is K4 in
fp32, returned in the weight operand's dtype; the bias-grad is a sum.

Each wrapper launches its kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# Launches of the kernels (not of the plain versions) in this process:
# K3 as the forward, K3 as the data-grad, K4.
LAUNCHES = {"conv3x3": 0, "conv3x3_dgrad": 0, "conv3x3_wgrad": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_C_ALIGN = 32  # K3's K step: input channels are zero-padded to this
_WG_TILE = 64  # K4's tile: channels and output channels are padded to this
_WG_BK = 32    # K4's pixels a step (bf16; fp32 takes 16, a divisor)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  pad: int) -> torch.Tensor:
    """F.conv2d on fp32-upcast operands, bias in fp32, cast back to x.dtype."""
    y = F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                 padding=pad)
    return y.to(x.dtype)


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor, pad: int) -> torch.Tensor:
    """The JAX `_wgrad` (`conv3x3.py:206-220`): dW (O, C, 3, 3) fp32, nine
    fp32 contractions of the shifted, zero-padded x with g over pixels."""
    xp = F.pad(x.float(), (pad, pad, pad, pad))
    gf = g.float()
    ho, wo = g.shape[2], g.shape[3]
    taps = [torch.einsum("bchw,bohw->oc", xp[:, :, ky:ky + ho, kx:kx + wo], gf)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, -1).reshape(g.shape[1], x.shape[1], 3, 3)


def _check(x, w, pad):
    if pad not in (0, 1, 2):
        raise ValueError(f"conv3x3: pad must be 0, 1 or 2, got {pad}")
    if x.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(
            f"conv3x3: x {tuple(x.shape)} and w {tuple(w.shape)} "
            "do not form a 3x3 conv")


def _conv(x, w, b, pad, counter):
    """K3 for a CUDA tensor, the plain version for a CPU one; no autograd."""
    if not x.is_cuda:
        return conv3x3_plain(x, w, b, pad)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv3x3: dtype {x.dtype} is not bf16 or fp32")
    bsz, c, h, wd = x.shape
    o = w.shape[0]
    ho, wo = h + 2 * pad - 2, wd + 2 * pad - 2
    cp = -(-c // _C_ALIGN) * _C_ALIGN
    # NHWC views; channels padded with zeros up to the K step.
    xh = x.permute(0, 2, 3, 1)
    xh = F.pad(xh, (0, cp - c)) if cp != c else xh.contiguous()
    wk = w.to(device=x.device, dtype=x.dtype).permute(0, 2, 3, 1)
    wk = F.pad(wk, (0, cp - c)) if cp != c else wk.contiguous()
    bias = None if b is None else b.to(device=x.device,
                                       dtype=torch.float32).contiguous()
    y = torch.empty((bsz, o, ho, wo), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last)
    if xh.data_ptr() % 16 or wk.data_ptr() % 16:
        raise ValueError("conv3x3: operands are not 16-byte aligned")
    err = _build.library().jp_conv3x3_fwd(
        xh.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), bsz, h, wd, cp, o, pad, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3")
    LAUNCHES[counter] += 1
    return y


def _nhwc_padded(t: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, C, H, W) -> contiguous (B, H, W, channels), zero-padded channels."""
    th = t.permute(0, 2, 3, 1)
    c = t.shape[1]
    return F.pad(th, (0, channels - c)) if channels != c else th.contiguous()


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, pad: int) -> torch.Tensor:
    """dL/dW (O, C, 3, 3) fp32 of the 3x3 conv of x (B, C, H, W) at `pad`,
    given the output cotangent g (B, O, Ho, Wo) in x's dtype: kernel K4 for
    a CUDA tensor, the plain version for a CPU one."""
    if pad not in (0, 1, 2):
        raise ValueError(f"conv3x3_wgrad: pad must be 0, 1 or 2, got {pad}")
    if not x.is_cuda:
        return conv3x3_wgrad_plain(x, g, pad)
    if x.dtype not in _DTYPE_CODE or g.dtype != x.dtype:
        raise TypeError(f"conv3x3_wgrad: dtypes {x.dtype}, {g.dtype}; "
                        "want one of bf16 and fp32 for both")
    bsz, c, h, wd = x.shape
    o, ho, wo = g.shape[1], g.shape[2], g.shape[3]
    if g.shape[0] != bsz or (ho, wo) != (h + 2 * pad - 2, wd + 2 * pad - 2):
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} do not match at pad {pad}")
    cp = -(-c // _WG_TILE) * _WG_TILE
    op = -(-o // _WG_TILE) * _WG_TILE
    xh, gh = _nhwc_padded(x, cp), _nhwc_padded(g, op)
    if xh.data_ptr() % 16 or gh.data_ptr() % 16:
        raise ValueError("conv3x3_wgrad: operands are not 16-byte aligned")
    m = bsz * ho * wo
    # Split the pixels so that about four blocks run on each SM.
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tiles = 9 * (cp // _WG_TILE) * (op // _WG_TILE)
    steps = -(-m // _WG_BK)
    splits = max(1, min(-(-4 * sms // tiles), steps // 16))
    chunk = -(-steps // splits) * _WG_BK
    splits = -(-m // chunk)
    partial = torch.empty((splits, 9, cp, op), device=x.device, dtype=torch.float32)
    out = torch.empty((9, cp, op), device=x.device, dtype=torch.float32)
    err = _build.library().jp_conv3x3_wgrad(
        xh.data_ptr(), gh.data_ptr(), partial.data_ptr(), out.data_ptr(),
        bsz, h, wd, cp, op, pad, chunk, splits, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_wgrad")
    LAUNCHES["conv3x3_wgrad"] += 1
    return out[:, :c, :o].permute(2, 1, 0).reshape(o, c, 3, 3)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, pad):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        ctx.bias_dtype = None if b is None else b.dtype
        return _conv(x, w, b, pad, "conv3x3")

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pad = ctx.pad
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # (O, C, ky, kx) -> (C, O, 2-ky, 2-kx): the data-grad is a conv.
            wt = w.flip(2, 3).transpose(0, 1)
            dx = _conv(g.to(x.dtype), wt.to(x.dtype), None, 2 - pad,
                       "conv3x3_dgrad")
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(x, g.to(x.dtype), pad).to(w.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum((0, 2, 3)).to(ctx.bias_dtype)
        return dx, dw, db, None


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                pad: int) -> torch.Tensor:
    """3x3 stride-1 conv: x (B, C, H, W), w (O, C, 3, 3), b (O,) or None,
    differentiable in x, w and b.

    pad 1 is SAME zero padding; pad 0 is VALID on a pre-padded input; pad 2
    is the full conv (the data-grad of VALID).
    """
    _check(x, w, pad)
    return _Conv3x3.apply(x, w, b, pad)


# -- the two eligibility gates (`jperceiver_tpu/ops/pallas/conv3x3.py:261-306`)

def shallow_gate(c_in: int, c_out: int, h: int, w: int) -> bool:
    """`use_pallas_conv`: 48 <= C_in <= 128, C_out <= 128, H*W >= 128^2,
    H and W even (h, w are the OUTPUT extent)."""
    if h < 8 or w < 8 or h % 2 or w % 2:
        return False
    if not (48 <= c_in <= 128 and c_out <= 128):
        return False
    return h * w >= 16384


def deep_gate(c_in: int, c_out: int, h: int, w: int) -> bool:
    """`use_pallas_conv_deep`: C_in >= 128, C_out >= 128, H*W >= 64^2."""
    if h < 8 or w < 8:
        return False
    return c_in >= 128 and c_out >= 128 and h * w >= 4096


def conv_site_eligible(c_in: int, c_out: int, h: int, w: int,
                       shallow: bool, deep: bool) -> bool:
    """Whether a stride-1 3x3 site goes to K3, deep gate first as in JAX
    (`jperceiver_tpu/models/common.py:373-389`)."""
    if deep and deep_gate(c_in, c_out, h, w):
        return True
    return shallow and shallow_gate(c_in, c_out, h, w)
