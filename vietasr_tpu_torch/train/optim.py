"""Optimizers as `torch.optim.Optimizer`s with a device-side NaN guard
(counterpart of vietasr_tpu/train/optim.py and the optax transformations
it builds).

Each optimizer computes the JAX package's update in its order of
operations, and `step(finite=...)` applies it only where the 0-d bool
tensor `finite` holds: parameters, moments and the step counter keep their
old values otherwise (the JAX train step's `keep_if_finite`), with no host
round trip. The step counter is a device int32 tensor per parameter group
("step"), and a learning rate may be a schedule of it (train/schedules.py).

- Novograd (arXiv:1905.11286) in the reference's exact order: per-tensor
  scalar second moment bootstrapped with v == 0 -> |g|^2, the gradient
  normalized by sqrt(v) + eps, weight decay added after normalization,
  optional grad averaging (1 - beta1) and LUC trust-ratio clipping; the
  learning rate is lr(step + 1).
- Adam, AdamW and SGD (+ momentum, + weight decay) as optax computes them;
  their learning rate is lr(count), the number of updates before this one
  (optax's scale_by_schedule).
- `grad_clip_norm` clips by the global norm first (optax
  clip_by_global_norm).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional

import torch


def _assign(dst: torch.Tensor, value: torch.Tensor,
            finite: Optional[torch.Tensor]) -> None:
    dst.copy_(value if finite is None else torch.where(finite, value, dst))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(t.float()))
                                   for t in tensors]).sum())


class _GuardedOptimizer(torch.optim.Optimizer):
    """The shared step: clip, per-parameter update, guarded assignment."""

    def __init__(self, params, defaults: dict, learning_rate,
                 grad_clip_norm: Optional[float]):
        super().__init__(params, defaults)
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm

    def _lr(self, step: torch.Tensor):
        lr = self.learning_rate
        return lr(step) if callable(lr) else lr

    def _init_state(self, p: torch.Tensor) -> dict:
        raise NotImplementedError

    def _update(self, p, g, state: dict, group: dict, count: torch.Tensor):
        """-> (new parameter, {state key: new value})."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None, *,
             finite: Optional[torch.Tensor] = None):
        """One update from each parameter's .grad; where `finite` (0-d
        bool) is False nothing changes, the step counter included."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if self.grad_clip_norm:
                norm = global_norm(grads)
                grads = [torch.where(norm < self.grad_clip_norm, g,
                                     (g / norm) * self.grad_clip_norm)
                         for g in grads]
            if "step" not in group:
                group["step"] = torch.zeros((), dtype=torch.int32,
                                            device=params[0].device)
            count = group["step"]
            for p, g in zip(params, grads):
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                new_p, new_state = self._update(p, g, state, group, count)
                _assign(p, new_p, finite)
                for key, value in new_state.items():
                    _assign(state[key], value, finite)
            _assign(count, count + 1, finite)
        return loss


class Novograd(_GuardedOptimizer):
    """Novograd with the reference's update order (see the module doc)."""

    def __init__(self, params: Iterable[torch.Tensor], lr, *,
                 betas=(0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_averaging: bool = False,
                 luc: bool = False, luc_trust: float = 1e-3,
                 luc_eps: float = 1e-8,
                 grad_clip_norm: Optional[float] = None):
        super().__init__(params, dict(betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      grad_averaging=grad_averaging, luc=luc,
                                      luc_trust=luc_trust, luc_eps=luc_eps),
                         lr, grad_clip_norm)

    def _init_state(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros((), dtype=torch.float32,
                                          device=p.device)}

    def _update(self, p, g, state, group, count):
        beta1, beta2 = group["betas"]
        lr = self._lr(count + 1)
        m, v = state["exp_avg"], state["exp_avg_sq"]
        norm_sq = torch.sum(torch.square(g).to(torch.float32))
        v_new = torch.where(v == 0, norm_sq, beta2 * v + (1 - beta2) * norm_sq)
        g_hat = g / (torch.sqrt(v_new) + group["eps"])
        if group["weight_decay"]:
            g_hat = g_hat + group["weight_decay"] * p
        if group["grad_averaging"]:
            g_hat = g_hat * (1 - beta1)
        m_new = beta1 * m + g_hat
        if group["luc"]:
            factor = group["luc_trust"] * torch.linalg.norm(p) \
                / (torch.linalg.norm(m_new) + group["luc_eps"])
            update = -torch.minimum(factor, torch.as_tensor(
                lr, dtype=factor.dtype, device=factor.device)) * m_new
        else:
            update = -lr * m_new
        return p + update, {"exp_avg": m_new, "exp_avg_sq": v_new}


class Adam(_GuardedOptimizer):
    """optax.adam, or optax.adamw when decoupled_weight_decay > 0."""

    def __init__(self, params, lr, *, betas=(0.9, 0.999), eps: float = 1e-8,
                 decoupled_weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None):
        super().__init__(params, dict(betas=tuple(betas), eps=eps,
                                      weight_decay=decoupled_weight_decay),
                         lr, grad_clip_norm)

    def _init_state(self, p):
        return {"exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def _update(self, p, g, state, group, count):
        beta1, beta2 = group["betas"]
        mu = (1 - beta1) * g + beta1 * state["exp_avg"]
        nu = (1 - beta2) * torch.square(g) + beta2 * state["exp_avg_sq"]
        n = (count + 1).to(torch.float32)
        mu_hat = mu / (1 - beta1 ** n)
        nu_hat = nu / (1 - beta2 ** n)
        u = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        return p + (-self._lr(count)) * u, {"exp_avg": mu, "exp_avg_sq": nu}


class SGD(_GuardedOptimizer):
    """optax.sgd with momentum (a trace, not Nesterov), optionally after
    add_decayed_weights."""

    def __init__(self, params, lr, *, momentum: float = 0.9,
                 weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None):
        super().__init__(params, dict(momentum=momentum,
                                      weight_decay=weight_decay),
                         lr, grad_clip_norm)

    def _init_state(self, p):
        return {"momentum_buffer": torch.zeros_like(p)}

    def _update(self, p, g, state, group, count):
        if group["weight_decay"]:
            g = g + group["weight_decay"] * p
        trace = g + group["momentum"] * state["momentum_buffer"]
        return p + (-self._lr(count)) * trace, {"momentum_buffer": trace}


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def make_optimizer(name: str, learning_rate, *, weight_decay: float = 0.0,
                   betas=None, momentum: float = 0.9,
                   grad_clip_norm: Optional[float] = None,
                   larc: bool = False) -> OptimizerFactory:
    """The reference's optimizer set (sgd / adam / adam_w / novograd, with
    grad-norm clipping) as a constructor: call it on the parameters
    (TrainState.create does). LAMB and LARC are not ported yet."""
    name = name.lower()
    if name == "lamb" or larc:
        raise NotImplementedError(
            "LAMB and LARC are not ported yet (ROADMAP A.8)")
    kw = dict(grad_clip_norm=grad_clip_norm)
    if name == "novograd":
        return functools.partial(Novograd, lr=learning_rate,
                                 betas=betas or (0.95, 0.98),
                                 weight_decay=weight_decay, **kw)
    if name == "adam":
        return functools.partial(Adam, lr=learning_rate,
                                 betas=betas or (0.9, 0.999), **kw)
    if name in ("adamw", "adam_w"):
        return functools.partial(Adam, lr=learning_rate,
                                 betas=betas or (0.9, 0.999),
                                 decoupled_weight_decay=weight_decay, **kw)
    if name == "sgd":
        return functools.partial(SGD, lr=learning_rate, momentum=momentum,
                                 weight_decay=weight_decay, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
