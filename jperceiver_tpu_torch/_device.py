"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises, rather than running on the CPU, when CUDA is asked
    for (or left to the default) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jperceiver_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev
