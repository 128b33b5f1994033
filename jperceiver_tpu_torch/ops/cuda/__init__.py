"""Hand-written Hopper kernels (CUDA C++ under `csrc/`) and their wrappers.

Each wrapper launches its kernel for a CUDA tensor and takes the kernel's
plain PyTorch version, defined beside it, only for a CPU tensor. Kernels
are built at first use (`_build.py`).
"""

from . import conv3x3, maxpool
from .conv3x3 import conv3x3_fwd, conv3x3_plain
from .maxpool import maxpool5x5_fwd, maxpool5x5_plain

_COUNTS = (conv3x3.LAUNCHES, maxpool.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches made in this process, by kernel."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


__all__ = ["conv3x3_fwd", "conv3x3_plain", "maxpool5x5_fwd",
           "maxpool5x5_plain", "launch_counts", "reset_launch_counts"]
