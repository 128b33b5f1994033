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


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small tensor of the Python numbers `values` (a nested list), made
    on `device` by one fill an element. `torch.tensor(values, device=...)`
    copies them from host memory instead: a CUDA graph capture refuses that
    copy, and outside one the host waits for it."""
    shape, flat = [], values
    while isinstance(flat, (list, tuple)):
        shape.append(len(flat))
        flat = flat[0] if flat else None
    out = torch.empty(shape, dtype=dtype, device=device)
    for i, v in enumerate(_flatten(values)):
        out.view(-1)[i].fill_(v)
    return out


def _flatten(values):
    if isinstance(values, (list, tuple)):
        for v in values:
            yield from _flatten(v)
    else:
        yield values
