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

`LAUNCHES` of each wrapper module counts the launches its wrappers make;
K3's and K4's are counted by shape too (`conv3x3.SHAPES`,
`launch_shapes()`), from which a reader works out their work, and K3's
float32 launches that took the TF32 path apart (`tf32_launch_counts()`).
A wrapper called inside a CUDA graph capture counts a launch the capture
only records; `GraphLaunches` takes those counts back and adds them at
each replay, which calls no wrapper, so that the counts stay the kernels
that ran.
"""

import contextlib

from . import conv3x3, maxpool, reproj
from .conv3x3 import conv3x3_fwd, conv3x3_plain, conv3x3_wgrad, conv3x3_wgrad_plain
from .maxpool import (maxpool3x3s2, maxpool3x3s2_bwd, maxpool3x3s2_bwd_plain, maxpool5x5,
                      maxpool5x5_bwd, maxpool5x5_bwd_plain, maxpool5x5_fwd, maxpool5x5_plain)
from .reproj import reproj_min, reproj_min_automask, reproj_min_plain

_COUNTS = (conv3x3.LAUNCHES, maxpool.LAUNCHES, reproj.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches made in this process, by kernel."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def tf32_launch_counts() -> dict[str, int]:
    """Of K3's launches in this process ("conv3x3" as the forward,
    "conv3x3_dgrad" as the data-grad), those on float32 operands that took
    the TF32 kernel (`torch.backends.cudnn.allow_tf32` set at the call)."""
    return dict(conv3x3.TF32_LAUNCHES)


def launch_shapes() -> dict[tuple, int]:
    """K3 and K4 launches made in this process by shape: (kernel, dtype, N,
    H, W, C_in, C_out, pad) -> launches; the kernel is "conv3x3",
    "conv3x3_dgrad" or "conv3x3_wgrad", H and W the input's extent, the
    channels unpadded."""
    return dict(conv3x3.SHAPES)


def reset_launch_counts() -> None:
    """Zero `launch_counts()` and `tf32_launch_counts()`, and empty
    `launch_shapes()`."""
    for counts in (*_COUNTS, conv3x3.TF32_LAUNCHES):
        for k in counts:
            counts[k] = 0
    conv3x3.SHAPES.clear()


def _diff(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def _add(delta: dict[str, int], tf32: dict[str, int], shapes: dict[tuple, int],
         times: int) -> None:
    for counts in _COUNTS:
        for k in counts.keys() & delta.keys():
            counts[k] += times * delta[k]
    for k, n in tf32.items():
        conv3x3.TF32_LAUNCHES[k] += times * n
    for k, n in shapes.items():
        conv3x3.SHAPES[k] += times * n
        if not conv3x3.SHAPES[k]:
            del conv3x3.SHAPES[k]


class GraphLaunches:
    """The launches of the hand kernels that one captured graph holds.

    `capture()` wraps the capture: what the wrappers count inside it is
    taken back (a capture runs no kernel) and kept as `per_replay`,
    `per_replay_tf32` and `per_replay_shapes`; `replayed()` adds them once
    a replay."""

    def __init__(self):
        self.per_replay: dict[str, int] = {}
        self.per_replay_tf32: dict[str, int] = {}
        self.per_replay_shapes: dict[tuple, int] = {}

    @contextlib.contextmanager
    def capture(self):
        before, tf32, shapes = launch_counts(), tf32_launch_counts(), launch_shapes()
        try:
            yield self
        finally:
            self.per_replay = _diff(launch_counts(), before)
            self.per_replay_tf32 = _diff(tf32_launch_counts(), tf32)
            self.per_replay_shapes = _diff(launch_shapes(), shapes)
            self._add(-1)

    def replayed(self) -> None:
        self._add(1)

    def _add(self, times: int) -> None:
        _add(self.per_replay, self.per_replay_tf32, self.per_replay_shapes, times)


__all__ = ["conv3x3_fwd", "conv3x3_plain", "conv3x3_wgrad",
           "conv3x3_wgrad_plain", "maxpool3x3s2", "maxpool3x3s2_bwd",
           "maxpool3x3s2_bwd_plain", "maxpool5x5",
           "maxpool5x5_bwd", "maxpool5x5_bwd_plain", "maxpool5x5_fwd",
           "maxpool5x5_plain", "reproj_min",
           "reproj_min_automask", "reproj_min_plain", "GraphLaunches", "launch_counts",
           "launch_shapes", "reset_launch_counts", "tf32_launch_counts"]
