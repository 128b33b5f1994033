"""3x3 stride-1 convolution forward: kernel K3 and its plain version.

Counterpart of `jperceiver_tpu/ops/pallas/conv3x3.py` (`pallas_conv3x3` for
pad 1, `pallas_conv3x3_valid` for pad 0). The kernel is
`csrc/conv3x3.cu`, an implicit GEMM over channels-last tiles; see there for
its design and bound.

Contract: operands in their input dtype (bf16 or fp32), fp32 accumulation,
the bias added to the fp32 accumulator, the output in the input dtype.
Tensors are NCHW at this interface; the kernel reads channels-last memory,
so the wrapper takes an NCHW tensor in channels-last memory format as it is
and returns its output in that format.

`conv3x3_fwd` launches the kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# Launches of the kernel (not of the plain version) in this process.
LAUNCHES = {"conv3x3": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_C_ALIGN = 32  # the kernel's K step: input channels are zero-padded to this


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  pad: int) -> torch.Tensor:
    """F.conv2d on fp32-upcast operands, bias in fp32, cast back to x.dtype."""
    y = F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                 padding=pad)
    return y.to(x.dtype)


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                pad: int) -> torch.Tensor:
    """3x3 stride-1 conv: x (B, C, H, W), w (O, C, 3, 3), b (O,) or None.

    pad 1 is SAME zero padding; pad 0 is VALID on a pre-padded input.
    """
    if pad not in (0, 1):
        raise ValueError(f"conv3x3_fwd: pad must be 0 or 1, got {pad}")
    if x.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(
            f"conv3x3_fwd: x {tuple(x.shape)} and w {tuple(w.shape)} "
            "do not form a 3x3 conv")
    if not x.is_cuda:
        return conv3x3_plain(x, w, b, pad)
    return _launch(x, w, b, pad)


def _launch(x, w, b, pad):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv3x3_fwd: dtype {x.dtype} is not bf16 or fp32")
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
        raise ValueError("conv3x3_fwd: operands are not 16-byte aligned")
    err = _build.library().jp_conv3x3_fwd(
        xh.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), bsz, h, wd, cp, o, pad, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_fwd")
    LAUNCHES["conv3x3"] += 1
    return y


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
