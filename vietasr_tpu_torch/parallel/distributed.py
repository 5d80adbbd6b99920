"""Multi-process coordination on torch.distributed (counterpart of
vietasr_tpu/parallel/distributed.py, with its contracts):

  jax.distributed.initialize()      -> initialize_multihost
                                       (init_process_group: NCCL on CUDA,
                                       gloo on the CPU)
  psum of a health flag             -> sync_all_processes (MIN all-reduce)
  broadcast_one_to_all              -> broadcast_string (uint8 broadcast)
  process_allgather                 -> gather_eval_results (all_gather)

Every helper is a no-op or a local passthrough in a one-process run, so
the same training script runs on one GPU and on many. A process drives
one device: `cli train` gives process i `cuda:<i % device_count>`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vietasr_tpu_torch.utils.device import resolve_device


def world_size(group=None) -> int:
    """Processes in `group` (the world by default); 1 without a group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device=None, backend: Optional[str] = None) -> dict:
    """Join the default process group when more than one process runs, and
    return the topology under JAX's four keys. A no-op for one process
    (no group is created). The coordinator's "host:port" becomes a tcp://
    init method; an address with a scheme (tcp://, file://) is used as it
    is. The backend is NCCL when `device` (None: CUDA)
    is a CUDA device and gloo on the CPU, unless `backend` names one (two
    ranks sharing one GPU need gloo: NCCL refuses them). A CUDA device
    becomes the process's current device before the group starts.
    local_devices is 1 (a process drives one device), global_devices the
    process count."""
    if num_processes is not None and num_processes > 1 \
            and not dist.is_initialized():
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-process run needs coordinator_address "
                             "and process_id")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    n = world_size()
    return {"process_index": process_index(), "process_count": n,
            "local_devices": 1, "global_devices": n}


def is_main_process() -> bool:
    return process_index() == 0


def comm_device(group=None) -> torch.device:
    """Where a collective's buffers live: the current CUDA device under
    NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync_all_processes(status: bool = True) -> None:
    """Cooperative failure barrier: every process contributes a flag, a MIN
    all-reduce combines them, and every process raises if any flag was
    False."""
    if world_size() == 1:
        if not status:
            raise RuntimeError("process signalled failure")
        return
    flag = torch.tensor([1 if status else 0], dtype=torch.int32,
                        device=comm_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    dist.barrier()
    if int(flag[0]) == 0:
        raise RuntimeError("at least one process signalled failure")


def broadcast_string(s: str, max_len: int = 256) -> str:
    """Rank 0's string on every process: its UTF-8 bytes (at most
    `max_len`) in a zero-padded uint8 buffer broadcast from rank 0."""
    if world_size() == 1:
        return s
    buf = np.zeros(max_len, np.uint8)
    raw = s.encode("utf-8")[:max_len]
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    t = torch.from_numpy(buf).to(comm_device())
    dist.broadcast(t, src=0)
    out = t.cpu().numpy()
    return bytes(out[out != 0]).decode("utf-8")


def gather_eval_results(local: np.ndarray) -> np.ndarray:
    """Every process's fixed-shape array on every process, stacked as
    (processes, ...); the array itself in a one-process run."""
    if world_size() == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local)).to(comm_device())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()
