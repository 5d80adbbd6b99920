"""Data and tensor parallelism on torch.distributed (counterpart of
vietasr_tpu/parallel/)."""

from vietasr_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    replicate,
    data_parallel_shardings,
)
from vietasr_tpu_torch.parallel.distributed import (
    initialize_multihost,
    sync_all_processes,
    broadcast_string,
    gather_eval_results,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_shardings",
    "initialize_multihost",
    "sync_all_processes",
    "broadcast_string",
    "gather_eval_results",
]
