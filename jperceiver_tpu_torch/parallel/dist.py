"""Data parallelism over `torch.distributed` (counterpart of
`jperceiver_tpu/parallel/mesh.py`).

One process per card (or per CPU worker in tests), started by `torchrun`
or anything that sets its environment: `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`. Each rank's loader yields its own shard of
the epoch (`data/loader.py`, rank-strided), so a step's global batch is
W * B samples, rank r holding rows [r * B, (r + 1) * B) of it. Nothing here
treats a rank's batch as the global one (the pitfall `mesh.py::shard_batch`
documents for JAX): what JAX computes over the global array, the port
computes from all-reduced sums (`models/common.py::BatchNorm2d`, the two
batch-wide ratios of the losses) or from a global draw of which each rank
keeps its rows (`rank_rows`: dropout, the automask noise).

Without a process group every helper is the single-process identity.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """Whether a process group exists (of any size, one rank included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(backend: str | None = None, timeout_s: float = 1800.0,
                     device=None) -> tuple[int, int]:
    """Join the process group that torchrun's environment describes;
    returns (rank, world size). `device` is the rank's (`local_device`:
    default `cuda:LOCAL_RANK`), and becomes the process's current card.
    `backend` defaults to NCCL on a card and gloo on the CPU; gloo may be
    named on the card too (two ranks that share one card: NCCL refuses
    them). A collective that waits longer than `timeout_s` raises."""
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    missing = [k for k, v in env.items() if v is None]
    if missing:
        raise RuntimeError(f"init_distributed: {missing} not set (start the job with torchrun)")
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank(), world_size()


def local_device(device=None) -> torch.device:
    """The device a rank runs on: `device` when given, else its card,
    `cuda:LOCAL_RANK`."""
    return torch.device(device if device is not None else f"cuda:{local_rank()}")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, with a gradient (the backward sums
    the ranks' cotangents); `x` itself when there is no process group."""
    if not is_distributed():
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, detached: a denominator that carries
    no gradient."""
    return all_reduce_sum(x.detach())


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks, detached."""
    return global_sum(x) / world_size()


def rank_rows(draw, local_shape, dim: int = 0) -> torch.Tensor:
    """A random draw made for the global batch, of which this rank keeps its
    rows: `draw(shape)` is called with `local_shape` widened W times along
    `dim` (the same draw on every rank, from the step's generator, which
    has the same seed everywhere), and rows [r * B, (r + 1) * B) of it are
    returned. One process gets `draw(local_shape)` itself, so a W-rank step
    draws what one process at the global batch draws."""
    w = world_size()
    if w == 1:
        return draw(tuple(local_shape))
    shape = list(local_shape)
    b = shape[dim]
    shape[dim] = b * w
    return draw(tuple(shape)).narrow(dim, rank() * b, b)


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def rank0_value(value):
    """Rank 0's `value` on every rank (a picklable object)."""
    if not is_distributed():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]
