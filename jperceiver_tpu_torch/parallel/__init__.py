"""Data parallelism: the process group, the ranks and the collectives the
training step uses (counterpart of `jperceiver_tpu/parallel/`)."""

from .dist import (all_reduce_mean, all_reduce_sum, backend, barrier, can_capture,
                   check_same_on_every_rank, global_sum, init_distributed, is_distributed,
                   local_device, local_rank, rank, rank0_value, rank_rows, world_size)

__all__ = ["all_reduce_mean", "all_reduce_sum", "backend", "barrier", "can_capture",
           "check_same_on_every_rank", "global_sum", "init_distributed", "is_distributed",
           "local_device", "local_rank", "rank", "rank0_value", "rank_rows", "world_size"]
