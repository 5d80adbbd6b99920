"""Learning-rate policies as functions of the step (counterpart of
vietasr_tpu/train/schedules.py).

The reference's lr_policies: a warmup ramp lr * (step+1) / (warmup+1), an
optional hold, then an annealing tail (cosine, square, square root, inverse
square root, polynomial), min_lr past total_steps. A schedule takes the
step as an int or a tensor and returns an fp32 tensor on the step's device,
so the train step evaluates it on the GPU without a host round trip.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Schedule = Callable[[object], torch.Tensor]


def _as_step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _with_warmup(initial_lr: float, warmup_steps: int, total_steps: int,
                 min_lr: float, hold_steps: int, tail) -> Schedule:
    def schedule(step) -> torch.Tensor:
        step = _as_step(step)
        warm = initial_lr * (step + 1) / (warmup_steps + 1)
        lr = torch.where(step < warmup_steps, warm,
                         torch.where(step < warmup_steps + hold_steps,
                                     torch.full_like(step, initial_lr),
                                     tail(step)))
        return torch.where(step > total_steps, torch.full_like(lr, min_lr),
                           lr)

    return schedule


def warmup_cosine(initial_lr: float, total_steps: int, *,
                  warmup_steps: int = 0, warmup_ratio: Optional[float] = None,
                  hold_steps: int = 0, min_lr: float = 0.0) -> Schedule:
    """CosineAnnealing."""
    if warmup_ratio is not None:
        warmup_steps = int(warmup_ratio * total_steps)

    def tail(step):
        mult = 0.5 * (1 + torch.cos(math.pi * step / total_steps))
        return (initial_lr - min_lr) * mult + min_lr

    return _with_warmup(initial_lr, warmup_steps, total_steps, min_lr,
                        hold_steps, tail)


warmup_hold_cosine = warmup_cosine


def square_annealing(initial_lr: float, total_steps: int, *,
                     warmup_steps: int = 0, min_lr: float = 0.0) -> Schedule:
    def tail(step):
        mult = ((total_steps - step) / total_steps) ** 2
        return torch.clamp_min(initial_lr * mult, min_lr)

    return _with_warmup(initial_lr, warmup_steps, total_steps, min_lr, 0, tail)


def squareroot_annealing(initial_lr: float, total_steps: int, *,
                         warmup_steps: int = 0, min_lr: float = 0.0
                         ) -> Schedule:
    def tail(step):
        mult = ((total_steps - step) / total_steps) ** 0.5
        return torch.clamp_min(initial_lr * mult, min_lr)

    return _with_warmup(initial_lr, warmup_steps, total_steps, min_lr, 0, tail)


def inverse_square_root(initial_lr: float, total_steps: int, *,
                        warmup_steps: int = 0, min_lr: float = 0.0
                        ) -> Schedule:
    """InverseSquareRootAnnealing: lr / sqrt(step / warmup)."""
    w = max(warmup_steps, 1)

    def tail(step):
        return initial_lr / torch.sqrt(torch.clamp_min(step, w) / w)

    return _with_warmup(initial_lr, warmup_steps, total_steps, min_lr, 0, tail)


def polynomial_decay(initial_lr: float, total_steps: int, *,
                     warmup_steps: int = 0, hold_steps: int = 0,
                     power: float = 1.0, min_lr: float = 0.0) -> Schedule:
    def tail(step):
        frac = torch.clamp(1.0 - step / total_steps, 0.0, 1.0)
        return (initial_lr - min_lr) * frac ** power + min_lr

    return _with_warmup(initial_lr, warmup_steps, total_steps, min_lr,
                        hold_steps, tail)


_POLICIES = {
    "CosineAnnealing": warmup_cosine,
    "WarmupAnnealing": polynomial_decay,        # linear decay after warmup
    "SquareAnnealing": square_annealing,
    "SquareRootAnnealing": squareroot_annealing,
    "InverseSquareRootAnnealing": inverse_square_root,
    "PolynomialDecayAnnealing": polynomial_decay,
    "PolynomialHoldDecayAnnealing": polynomial_decay,
}


def make_schedule(name: str, initial_lr: float, total_steps: int,
                  **kwargs) -> Schedule:
    """Look up a policy by its reference class name."""
    if name not in _POLICIES:
        raise ValueError(
            f"unknown lr policy {name!r}; known: {sorted(_POLICIES)}")
    return _POLICIES[name](initial_lr, total_steps, **kwargs)
