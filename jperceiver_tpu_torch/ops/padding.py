"""Reflection padding (counterpart of `jperceiver_tpu/ops/padding.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    """NCHW reflection pad (torch ReflectionPad2d semantics, the edge is not
    repeated): pad row -1 mirrors row 1, pad row H mirrors row H-2."""
    return F.pad(x, (p, p, p, p), mode="reflect")
