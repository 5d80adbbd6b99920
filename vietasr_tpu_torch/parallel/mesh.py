"""The ('data', 'model') device mesh and batch placement on
torch.distributed (counterpart of vietasr_tpu/parallel/mesh.py).

The JAX package shards arrays over a `jax.sharding.Mesh` and lets jit
insert the collectives. Here a process holds one device, the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the processes, and the
collectives are explicit: the data-parallel train step all-reduces the
BN sums, the valid-row count and the gradients over the 'data' axis
(train/loop.py), and the tensor-parallel Conformer all-reduces after each
row-sharded product over the 'model' axis (parallel/tp.py).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from vietasr_tpu_torch.parallel.distributed import world_size


def make_mesh(num_data: Optional[int] = None, num_model: int = 1):
    """A ('data', 'model') DeviceMesh of num_data x num_model processes over
    the default process group (initialize_multihost first); num_data
    defaults to world // num_model. Rank r sits at (r // num_model,
    r % num_model). Raises ValueError when the shape does not cover the
    world, as the JAX package does for its devices."""
    n = world_size()
    if num_data is None:
        num_data = n // num_model
    if num_data * num_model != n:
        raise ValueError(f"mesh {num_data}x{num_model} != {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group "
                           "(initialize_multihost)")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (num_data, num_model),
                            mesh_dim_names=("data", "model"))


def shard_batch(mesh, batch: dict) -> dict:
    """This process's contiguous rows of a global batch dict on the 'data'
    axis (tensors or numpy arrays with a leading batch axis; 0-d values
    pass whole). The batch must split evenly."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    i = mesh.get_local_rank("data")

    def take(x):
        if getattr(x, "ndim", 0) < 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {n} data shards")
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]

    return {k: take(v) for k, v in batch.items()}


def replicate(mesh, tree):
    """Rank 0's tensors on every process of the mesh (which spans the
    world): each leaf is copied and broadcast from rank 0."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicate(mesh, v) for v in tree]
    t = tree.detach().clone()
    dist.broadcast(t, src=0)
    return t


def data_parallel_shardings(mesh):
    """JAX's (replicated, batch-sharded) NamedShardings for jit's in/out
    specs. torch has no counterpart: nothing is annotated for a compiler
    to partition. A process holds the whole state and its rows
    (shard_batch), and the train step reduces over the 'data' group
    itself (`make_train_step(..., group=mesh.get_group("data"))`)."""
    raise NotImplementedError(
        "data_parallel_shardings has no torch counterpart: pass "
        "mesh.get_group('data') to make_train_step / Trainer instead")
