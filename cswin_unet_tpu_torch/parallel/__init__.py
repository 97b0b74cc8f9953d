"""Data parallelism over processes (``torch.distributed``) and over the
devices of one process (``eval.inference.VolumeInferencer``)."""

from .mesh import (all_reduce_mean_, all_reduce_sum, destroy_distributed,
                   devices_for_batch, init_distributed, launched, local_devices,
                   multihost_barrier, process_shard_info, rank_rows, world_size,
                   wrap_ddp)

__all__ = [
    "all_reduce_mean_",
    "all_reduce_sum",
    "destroy_distributed",
    "devices_for_batch",
    "init_distributed",
    "launched",
    "local_devices",
    "multihost_barrier",
    "process_shard_info",
    "rank_rows",
    "world_size",
    "wrap_ddp",
]
