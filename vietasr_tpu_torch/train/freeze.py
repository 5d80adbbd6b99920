"""Parameter freezing and scheduled hyperparameter annealing (counterpart
of vietasr_tpu/train/freeze.py), with optax's semantics rather than
torch's `requires_grad`.

Both wrappers take and return an optimizer constructor (make_optimizer's),
which TrainState.create calls with one parameter group whose "paths" name
each parameter as the JAX package's `_path_str` does
("encoder/0/sub/0/pw_w"):

- `freeze(opt, prefixes)`: the frozen parameters never reach the inner
  optimizer (optax.multi_transform with set_to_zero): it holds no state
  for them, so their weight decay stops too, and a global-norm clip sees
  the trained parameters only.
- `unfreeze_schedule(opt, {prefix: step})`: every parameter stays in the
  optimizer; under a prefix its gradient is zeroed before the update and
  the update dropped after it until the optimizer's step count reaches
  the step (the gate `_GuardedOptimizer.step` applies).
- `make_value_schedule`: fn(step) -> scalar tensor, for
  make_train_step(value_schedules=...) (SpecAugment band counts).
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch

from vietasr_tpu_torch.train.optim import OptimizerFactory, path_matches


def _groups_with_paths(params) -> list:
    groups = list(params)
    if not groups or not all(isinstance(g, dict) and "paths" in g
                             for g in groups):
        raise ValueError("freezing needs the parameters' paths: build the "
                         "optimizer through TrainState.create")
    return groups


def freeze(optimizer: OptimizerFactory,
           frozen_prefixes: Sequence[str]) -> OptimizerFactory:
    """Zero updates, and no optimizer state, for every parameter whose path
    starts with one of `frozen_prefixes` (e.g. ["encoder"] or
    ["encoder/0"])."""
    prefixes = list(frozen_prefixes)

    def build(params):
        groups = []
        for g in _groups_with_paths(params):
            keep = [i for i, path in enumerate(g["paths"])
                    if not path_matches(path, prefixes)]
            groups.append(dict(g, params=[g["params"][i] for i in keep],
                               paths=[g["paths"][i] for i in keep]))
        return optimizer(groups)

    return build


def unfreeze_schedule(optimizer: OptimizerFactory,
                      unfreeze_at: Mapping[str, int]) -> OptimizerFactory:
    """Parameters under prefix p get no update until the optimizer's step
    count reaches `unfreeze_at[p]` (0: never frozen); the first matching
    prefix decides."""
    schedule = {str(k): int(v) for k, v in unfreeze_at.items()}

    def build(params):
        return optimizer([dict(g, unfreeze_at=schedule)
                          for g in _groups_with_paths(params)])

    return build


def make_value_schedule(policy: str, start: float, end: float,
                        total_steps: int, *,
                        warmup_steps: int = 0) -> Callable:
    """fn(step) -> fp32 0-d tensor: `start` until `warmup_steps`, then a
    linear or exponential (geometric) anneal to `end` at `total_steps`."""
    policy = policy.lower()
    if policy not in ("linear", "exp", "exponential"):
        raise ValueError(f"unknown value-schedule policy {policy!r}")
    denom = float(max(total_steps - warmup_steps, 1))

    def fn(step):
        step = torch.as_tensor(step)
        s = torch.clamp((step - warmup_steps).to(torch.float32) / denom,
                        0.0, 1.0)
        if policy == "linear":
            return start + (end - start) * s
        ratio = torch.tensor(max(end, 1e-8) / max(start, 1e-8),
                             dtype=torch.float32, device=s.device)
        return start * ratio ** s

    return fn
