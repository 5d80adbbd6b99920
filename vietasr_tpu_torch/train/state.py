"""Train state: everything a step mutates, in one object (counterpart of
vietasr_tpu/train/state.py).

The JAX TrainState is an immutable pytree that each step replaces; here
the step updates it in place: `params` are leaf tensors that require
grad, `batch_stats` plain tensors, `optimizer` is bound to the flattened
params, and `step` / `skipped_steps` are int32 tensors on the device, so
the NaN guard counts a skip without a host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List

import torch

from vietasr_tpu_torch.models.quartznet import (map_tree, tree_leaves,
                                                tree_paths)


@dataclasses.dataclass
class TrainState:
    params: dict
    batch_stats: dict
    optimizer: torch.optim.Optimizer
    step: torch.Tensor                  # () int32, every step taken
    skipped_steps: torch.Tensor         # () int32, NaN/inf-guard skips

    @classmethod
    def create(cls, variables: dict,
               optimizer: Callable[[Iterable[torch.Tensor]],
                                   torch.optim.Optimizer],
               *, step: int = 0) -> "TrainState":
        """`variables`: {"params", "batch_stats"} trees of tensors on one
        device (copied); `optimizer`: a constructor from make_optimizer
        (or train/freeze.py's wrappers of one), given one parameter group
        whose "paths" name each parameter as the JAX package does."""
        params = map_tree(lambda t: t.detach().clone().to(torch.float32)
                          .requires_grad_(True), variables["params"])
        stats = map_tree(lambda t: t.detach().clone(),
                         variables.get("batch_stats") or {})
        dev = tree_leaves(params)[0].device
        return cls(params=params, batch_stats=stats,
                   optimizer=optimizer([{"params": tree_leaves(params),
                                         "paths": tree_paths(params)}]),
                   step=torch.full((), step, dtype=torch.int32, device=dev),
                   skipped_steps=torch.zeros((), dtype=torch.int32,
                                             device=dev))

    @property
    def variables(self) -> dict:
        return {"params": self.params, "batch_stats": self.batch_stats}

    def param_list(self) -> List[torch.Tensor]:
        return tree_leaves(self.params)

    def num_params(self) -> int:
        return sum(int(p.numel()) for p in self.param_list())
