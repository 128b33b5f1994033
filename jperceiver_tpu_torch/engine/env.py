"""Seeds and device information (counterpart of
`jperceiver_tpu/engine/env.py`)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed the host generators the data pipeline draws from (`random`,
    numpy) and torch's default generators (the CPU's and every card's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def device_summary() -> str:
    """The CUDA devices this process sees, and its rank and world size
    when `torch.distributed` is initialised."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    dist = torch.distributed
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_available() and dist.is_initialized() else (0, 1))
    return f"{n} CUDA device(s): {names}, process {rank}/{world}"
