"""Hand-written Hopper kernels (CUDA C++ under `csrc/`) and their wrappers.

Each wrapper launches its kernel for a CUDA tensor and takes the kernel's
plain PyTorch version, defined beside it, only for a CPU tensor. Kernels
are built at first use (`_build.py`). The differentiable entry points are
`torch.autograd.Function`s whose backwards are kernels where the TPU
kernel had one: K3 forward and data-grad with K4 as the weight-grad
(`conv3x3_fwd`), K1 with K2 (`reproj_min`, `reproj_min_automask`), and
K5 with its backward kernel (`maxpool5x5`). The stem pool
(`maxpool3x3s2`) keeps `F.max_pool2d` as its forward; its backward is a
kernel too.
"""

from . import conv3x3, maxpool, reproj
from .conv3x3 import conv3x3_fwd, conv3x3_plain, conv3x3_wgrad, conv3x3_wgrad_plain
from .maxpool import (maxpool3x3s2, maxpool3x3s2_bwd, maxpool3x3s2_bwd_plain, maxpool5x5,
                      maxpool5x5_bwd, maxpool5x5_bwd_plain, maxpool5x5_fwd, maxpool5x5_plain)
from .reproj import reproj_min, reproj_min_automask, reproj_min_plain

_COUNTS = (conv3x3.LAUNCHES, maxpool.LAUNCHES, reproj.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches made in this process, by kernel."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


__all__ = ["conv3x3_fwd", "conv3x3_plain", "conv3x3_wgrad",
           "conv3x3_wgrad_plain", "maxpool3x3s2", "maxpool3x3s2_bwd",
           "maxpool3x3s2_bwd_plain", "maxpool5x5",
           "maxpool5x5_bwd", "maxpool5x5_bwd_plain", "maxpool5x5_fwd",
           "maxpool5x5_plain", "reproj_min",
           "reproj_min_automask", "reproj_min_plain", "launch_counts", "reset_launch_counts"]
