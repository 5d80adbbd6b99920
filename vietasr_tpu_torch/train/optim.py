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
- LAMB as `optax.lamb`: scale_by_adam (eps 1e-6), decayed weights added,
  then each tensor's update scaled by the trust ratio |p| / |u| (1 where
  either norm is 0), then -lr(count).
- LARC (SGD only) as the JAX package chains it: the gradient scaled by
  larc_eta * |p| / |g| (1 where either norm is 0) before SGD, SGD's weight
  decay included.
- `grad_clip_norm` clips by the global norm first (optax
  clip_by_global_norm).

A parameter group may carry "paths" (each parameter's JAX path string,
which TrainState.create supplies) and "unfreeze_at" ({path prefix: step},
train/freeze.py's `unfreeze_schedule`): a parameter under such a prefix
has its gradient zeroed before the update (clipping included) and its
update dropped after it until the group's step count reaches that step,
as optax's gates do; its moments see the zeroed gradients meanwhile.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist


def _assign(dst: torch.Tensor, value: torch.Tensor,
            finite: Optional[torch.Tensor]) -> None:
    dst.copy_(value if finite is None else torch.where(finite, value, dst))


def global_norm(tensors, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm).
    Under tensor parallelism (`sharded`, per tensor: is it this rank's
    slice of a tensor split over `group`?) the sharded tensors' sum of
    squares is all-reduced over `group` first, so every rank gets the norm
    of the whole tensors."""
    if group is None or not any(sharded):
        return torch.sqrt(torch.stack([torch.sum(torch.square(t.float()))
                                       for t in tensors]).sum())
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    split = torch.stack([a for a, s in zip(sq, sharded) if s]).sum()
    dist.all_reduce(split, group=group)
    whole = [a for a, s in zip(sq, sharded) if not s]
    return torch.sqrt(torch.stack(whole).sum() + split if whole else split)


def trust_ratio(p: torch.Tensor, u: torch.Tensor,
                coefficient: float = 1.0, norm=torch.linalg.norm
                ) -> torch.Tensor:
    """optax.scale_by_trust_ratio's factor: coefficient * |p| / |u|, or 1
    where either norm is 0 (`norm` takes a tensor's norm)."""
    p_norm, u_norm = norm(p), norm(u)
    ratio = coefficient * p_norm / u_norm
    return torch.where((p_norm == 0) | (u_norm == 0),
                       torch.ones_like(ratio), ratio)


def path_matches(path: str, prefixes) -> bool:
    """Is `path` one of `prefixes` or below one ("encoder" holds
    "encoder/0/sub/0/pw_w")?"""
    return any(path == q or path.startswith(q + "/") for q in prefixes)


def _unfreeze_gates(group: dict, count: torch.Tensor) -> list:
    """Per parameter of the group: None (never gated) or a 0-d bool, true
    once `count` reaches the step of the first matching prefix."""
    schedule = group.get("unfreeze_at")
    if not schedule:
        return [None] * len(group["params"])
    if "paths" not in group:
        raise ValueError("unfreeze_at needs the parameters' paths (build "
                         "the optimizer through TrainState.create)")
    gates = []
    for path in group["paths"]:
        th = next((int(schedule[q]) for q in schedule
                   if path_matches(path, [q])), 0)
        gates.append(count >= th if th > 0 else None)
    return gates


class _GuardedOptimizer(torch.optim.Optimizer):
    """The shared step: clip, per-parameter update, guarded assignment."""

    def __init__(self, params, defaults: dict, learning_rate,
                 grad_clip_norm: Optional[float]):
        super().__init__(params, defaults)
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self._sharded: set = set()
        self._shard_group = None

    def tensor_parallel(self, sharded_params, group) -> None:
        """Mark `sharded_params` as this rank's slices of tensors split
        over `group`: every per-tensor norm of them (Novograd's second
        moment and LUC, LAMB's and LARC's trust ratios, the clipping
        norm) is then taken over the whole tensor by an all-reduce of the
        sum of squares."""
        self._sharded = {id(p) for p in sharded_params}
        self._shard_group = group

    def _sum_sq(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        s = torch.sum(torch.square(t).to(torch.float32))
        if id(p) in self._sharded:
            dist.all_reduce(s, group=self._shard_group)
        return s

    def _norm(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        if id(p) in self._sharded:
            return torch.sqrt(self._sum_sq(t, p))
        return torch.linalg.norm(t)

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
            if "step" not in group:
                group["step"] = torch.zeros(
                    (), dtype=torch.int32,
                    device=group["params"][0].device if group["params"]
                    else None)
            count = group["step"]
            live = [(p, gate) for p, gate in zip(
                group["params"], _unfreeze_gates(group, count))
                if p.grad is not None]
            if not live:
                continue
            grads = [p.grad if gate is None
                     else torch.where(gate, p.grad, torch.zeros_like(p.grad))
                     for p, gate in live]
            if self.grad_clip_norm:
                norm = global_norm(grads, [id(p) in self._sharded
                                           for p, _ in live],
                                   self._shard_group)
                grads = [torch.where(norm < self.grad_clip_norm, g,
                                     (g / norm) * self.grad_clip_norm)
                         for g in grads]
            for (p, gate), g in zip(live, grads):
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                new_p, new_state = self._update(p, g, state, group, count)
                if gate is not None:
                    new_p = torch.where(gate, new_p, p)
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
        norm_sq = self._sum_sq(g, p)
        v_new = torch.where(v == 0, norm_sq, beta2 * v + (1 - beta2) * norm_sq)
        g_hat = g / (torch.sqrt(v_new) + group["eps"])
        if group["weight_decay"]:
            g_hat = g_hat + group["weight_decay"] * p
        if group["grad_averaging"]:
            g_hat = g_hat * (1 - beta1)
        m_new = beta1 * m + g_hat
        if group["luc"]:
            factor = group["luc_trust"] * self._norm(p, p) \
                / (self._norm(m_new, p) + group["luc_eps"])
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
        return (p + (-self._lr(count)) * self._rescale(p, u),
                {"exp_avg": mu, "exp_avg_sq": nu})

    def _rescale(self, p, u):
        return u


class Lamb(Adam):
    """optax.lamb: Adam's update (eps 1e-6) + weight decay, times the trust
    ratio |p| / |u|, times -lr(count)."""

    def __init__(self, params, lr, *, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None):
        super().__init__(params, lr, betas=betas, eps=eps,
                         decoupled_weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm)

    def _rescale(self, p, u):
        return u * trust_ratio(p, u, norm=lambda t: self._norm(t, p))


class SGD(_GuardedOptimizer):
    """optax.sgd with momentum (a trace, not Nesterov), optionally after
    add_decayed_weights; with `larc_eta`, after LARC's trust ratio."""

    def __init__(self, params, lr, *, momentum: float = 0.9,
                 weight_decay: float = 0.0, larc_eta: Optional[float] = None,
                 grad_clip_norm: Optional[float] = None):
        super().__init__(params, dict(momentum=momentum,
                                      weight_decay=weight_decay,
                                      larc_eta=larc_eta),
                         lr, grad_clip_norm)

    def _init_state(self, p):
        return {"momentum_buffer": torch.zeros_like(p)}

    def _update(self, p, g, state, group, count):
        if group["larc_eta"] is not None:
            g = g * trust_ratio(p, g, group["larc_eta"],
                                norm=lambda t: self._norm(t, p))
        if group["weight_decay"]:
            g = g + group["weight_decay"] * p
        trace = g + group["momentum"] * state["momentum_buffer"]
        return p + (-self._lr(count)) * trace, {"momentum_buffer": trace}


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


def novograd(learning_rate, betas=(0.95, 0.98), eps: float = 1e-8,
             weight_decay: float = 0.0, grad_averaging: bool = False,
             luc: bool = False, luc_trust: float = 1e-3,
             luc_eps: float = 1e-8) -> OptimizerFactory:
    """The JAX package's `novograd(...)` signature: a constructor of the
    Novograd optimizer, to call on the parameters."""
    return functools.partial(Novograd, lr=learning_rate, betas=betas,
                             eps=eps, weight_decay=weight_decay,
                             grad_averaging=grad_averaging, luc=luc,
                             luc_trust=luc_trust, luc_eps=luc_eps)


def make_optimizer(name: str, learning_rate, *, weight_decay: float = 0.0,
                   betas=None, momentum: float = 0.9,
                   grad_clip_norm: Optional[float] = None,
                   larc: bool = False,
                   larc_eta: float = 0.02) -> OptimizerFactory:
    """The reference's optimizer set (sgd / adam / adam_w / novograd /
    lamb, LARC around SGD, grad-norm clipping) as a constructor: call it on
    the parameters (TrainState.create does). `larc` wraps SGD only, as in
    the JAX package; other optimizers ignore it."""
    name = name.lower()
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
                                 weight_decay=weight_decay,
                                 larc_eta=larc_eta if larc else None, **kw)
    if name == "lamb":
        return functools.partial(Lamb, lr=learning_rate,
                                 betas=betas or (0.9, 0.999),
                                 weight_decay=weight_decay, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
