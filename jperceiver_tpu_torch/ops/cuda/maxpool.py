"""5x5 stride-1 SAME max-pool forward: kernel K5 and its plain version.

Counterpart of `jperceiver_tpu/ops/pallas/maxpool.py` (`pallas_fwd`, and the
`max_pool_5x5_s1` forward the CRP blocks run). Out-of-image positions count
as -inf. The kernel is `csrc/maxpool5x5.cu`; it reads channels-last memory,
so the wrapper takes an NCHW tensor in channels-last memory format as it is
and returns its output in that format. A max is exact, so the kernel and the
plain version agree bit for bit.

`maxpool5x5_fwd` launches the kernel for a CUDA tensor and takes the plain
version only for a CPU tensor.
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


def maxpool5x5_plain(x: torch.Tensor) -> torch.Tensor:
    """The separable form of `maxpool.py:51-91`: along W, then along H."""
    return _axis_max(_axis_max(x, 3), 2)


def maxpool5x5_fwd(x: torch.Tensor) -> torch.Tensor:
    """5x5 stride-1 SAME max-pool of x (B, C, H, W), -inf padding."""
    if x.dim() != 4:
        raise ValueError(f"maxpool5x5_fwd: x must be 4-D, got {tuple(x.shape)}")
    if not x.is_cuda:
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
