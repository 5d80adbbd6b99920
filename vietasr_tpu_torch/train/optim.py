"""Optimizers as `torch.optim.Optimizer`s with a device-side NaN guard
(counterpart of vietasr_tpu/train/optim.py and the optax transformations
it builds).

Each optimizer computes the JAX package's update in its order of
operations, and `step(finite=...)` applies it only where the 0-d bool
tensor `finite` holds: parameters, moments and the step counter keep their
old values otherwise (the JAX train step's `keep_if_finite`), with no host
round trip. The step counter is a device int32 tensor per parameter group
("step"), and a learning rate may be a schedule of it (train/schedules.py),
evaluated once a group and step.

- Novograd (arXiv:1905.11286) in the reference's exact order: per-tensor
  scalar second moment bootstrapped with v == 0 -> |g|^2, the gradient
  normalized by sqrt(v) + eps, weight decay added after normalization,
  optional grad averaging (1 - beta1) and LUC trust-ratio clipping
  (min(factor, lr)); the learning rate is lr(step + 1).
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
  clip_by_global_norm): every gradient times one 0-d factor.

A step works on a whole parameter group at once, so its number of kernel
launches does not grow with the number of tensors. The group's
parameters, gradients and moments are each copied by one
`torch._foreach_copy_` into a persistent fp32 vector that lays them end
to end (`Layout`: a vector and its views are made once, so a step makes
no view a tensor), and every elementwise formula runs once over the
vectors, in the order above. A per-tensor quantity (Novograd's second
moment, the squared norms, LUC's factor, LAMB's and LARC's trust ratios)
is a vector with one entry a tensor: the norms come from one
`torch._foreach_norm` over the group, and a vector reaches the elements
through one gather by a cached index of each element's tensor. Only
rounding differs from a loop over the tensors: the norms' order of
summation; the clip's one factor max / norm (optax divides by the norm,
then multiplies); and, after a clip, Novograd's |g|^2 taken as the clip's
own per-tensor sums times the factor squared, so one `_foreach_norm`
serves both. The results go back by one `torch._foreach_copy_` a state
key into the tensors `optimizer.state[p]` has always held (`exp_avg` like
p, Novograd's `exp_avg_sq` a 0-d fp32), so checkpoints and `state_dict()`
are as before.

The guard is an exact select: the new vector and the old one go through
one `torch.where(finite, new, old)` before the copy, so where `finite` is
False every tensor keeps its bits even when the gradients hold NaN or
inf, and the step counter adds `finite` (0 or 1).

Under tensor parallelism (`tensor_parallel`) the sharded tensors' sums of
squares are all-reduced in one call a norm vector, so every per-tensor
norm and the clipping norm are those of the whole tensors.

While tracing is on (utils/tracing.py) a step counts the tensors it
updated under `optim.multi_tensor`; no tensor takes a per-tensor path, so
`optim.per_tensor`, which would count those, stays at 0.

A parameter group may carry "paths" (each parameter's JAX path string,
which TrainState.create supplies) and "unfreeze_at" ({path prefix: step},
train/freeze.py's `unfreeze_schedule`): a parameter under such a prefix
has its gradient zeroed before the update (clipping included) and its
update dropped after it until the group's step count reaches that step,
as optax's gates do; its moments see the zeroed gradients meanwhile. The
gates are a vector of thresholds too, spread over the elements like the
others.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _unflatten_dense_tensors

from vietasr_tpu_torch.utils import tracing


def _sum_shards(sq: torch.Tensor, shard_mask: Optional[torch.Tensor],
                group) -> torch.Tensor:
    """Per-tensor sums of squares with the entries where `shard_mask`
    holds all-reduced over `group`, in one call."""
    if shard_mask is None:
        return sq
    part = torch.where(shard_mask, sq, 0.0)
    dist.all_reduce(part, group=group)
    return torch.where(shard_mask, part, sq)


def global_norm(tensors, sharded=None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm).
    Under tensor parallelism (`sharded`, per tensor: is it this rank's
    slice of a tensor split over `group`?) the sharded tensors' sums of
    squares are all-reduced over `group` first, in one call, so every rank
    gets the norm of the whole tensors."""
    tensors = list(tensors)
    mask = None
    if group is not None and any(sharded):
        mask = torch.tensor(sharded, device=tensors[0].device)
    norms = torch.stack(torch._foreach_norm(tensors, dtype=torch.float32))
    return torch.sqrt(_sum_shards(torch.square(norms), mask, group).sum())


def trust_ratio(p_norm: torch.Tensor, u_norm: torch.Tensor,
                coefficient: float = 1.0) -> torch.Tensor:
    """optax.scale_by_trust_ratio's factor from the norms of the
    parameters and of the update (vectors, one entry a tensor):
    coefficient * |p| / |u|, or 1 where either norm is 0."""
    ratio = coefficient * p_norm / u_norm
    return torch.where((p_norm == 0) | (u_norm == 0),
                       torch.ones_like(ratio), ratio)


def path_matches(path: str, prefixes) -> bool:
    """Is `path` one of `prefixes` or below one ("encoder" holds
    "encoder/0/sub/0/pw_w")?"""
    return any(path == q or path.startswith(q + "/") for q in prefixes)


def _unfreeze_steps(group: dict, live: List[int]) -> Optional[List[int]]:
    """Per live parameter of the group (by index): the step count from
    which it is updated (0: always); None when the group has no
    schedule."""
    schedule = group.get("unfreeze_at")
    if not schedule:
        return None
    if "paths" not in group:
        raise ValueError("unfreeze_at needs the parameters' paths (build "
                         "the optimizer through TrainState.create)")
    paths = group["paths"]
    return [next((int(schedule[q]) for q in schedule
                  if path_matches(paths[i], [q])), 0) for i in live]


class Layout:
    """A list of tensors laid end to end in persistent fp32 vectors, each
    made once a name and kept with its views: in the tensors' shapes, or,
    for a vector of `scalars`, one 0-d view an entry (one entry a tensor).
    A list goes in or out by one `torch._foreach_copy_`, so a step makes no
    view a tensor (each costs host time, and an event under the profiler).
    The tensors `like` fix the layout; a list given later holds tensors of
    their shapes, in their order."""

    def __init__(self, like):
        self._like = list(like)
        self.device = self._like[0].device
        self.sizes = [t.numel() for t in self._like]
        self._bufs: dict = {}
        self._scalar_names: dict = {}
        self._segment: Optional[torch.Tensor] = None

    def vector(self, name: str, scalars: bool = False) -> tuple:
        """(`name`'s vector, its views), made on the first call."""
        buf = self._bufs.get((name, scalars))
        if buf is None:
            data = torch.empty(len(self.sizes) if scalars else sum(self.sizes),
                               dtype=torch.float32, device=self.device)
            views = list(data.unbind() if scalars
                         else _unflatten_dense_tensors(data, self._like))
            buf = self._bufs[(name, scalars)] = (data, views)
        return buf

    def load(self, name: str, tensors, scalars: bool = False) -> torch.Tensor:
        """`name`'s vector, holding the tensors laid end to end. A list copy
        takes one launch only where every tensor is laid out as its view,
        so tensors laid out otherwise (autograd's gradient of a weight used
        transposed) go by a second list copy."""
        data, views = self.vector(name, scalars)
        odd = [i for i, t in enumerate(tensors) if not t.is_contiguous()]
        if not odd:
            torch._foreach_copy_(views, tensors)
            return data
        rest = sorted(set(range(len(views))) - set(odd))
        for part in (rest, odd):
            if part:
                torch._foreach_copy_([views[i] for i in part],
                                     [tensors[i] for i in part])
        return data

    def holds_scalars(self, name: str, tensors) -> bool:
        """Does the list `name` hold one 0-d tensor a tensor of the layout
        (Novograd's second moment), rather than one of its shape? Decided
        on the first list given under the name."""
        if name not in self._scalar_names:
            self._scalar_names[name] = any(
                t.shape != like.shape for t, like in zip(tensors, self._like))
        return self._scalar_names[name]

    def split(self, name: str, flat: torch.Tensor) -> list:
        """Views of `flat` in the shapes: its own where it is one of the
        layout's vectors, else those of `name`'s vector, copied from it."""
        for data, views in self._bufs.values():
            if data is flat:
                return views
        data, views = self.vector(name, False)
        data.copy_(flat)
        return views

    def store(self, dst, new: torch.Tensor, old: Optional[torch.Tensor] = None,
              where: Optional[torch.Tensor] = None,
              scalars: bool = False) -> None:
        """dst <- `new`; where the 0-d bool `where` is False, <- `old`: one
        select over the whole vector (exact: a NaN or inf in `new` reaches
        nothing), then one list copy."""
        data, views = self.vector("store", scalars)
        if where is None:
            data.copy_(new)
        else:
            torch.where(where, new, old, out=data)
        torch._foreach_copy_(dst, views)

    def expand(self, vec: torch.Tensor) -> torch.Tensor:
        """A vector with one entry a tensor -> one entry an element, by one
        gather through each element's tensor index (made once)."""
        if self._segment is None:
            self._segment = torch.repeat_interleave(
                torch.arange(len(self.sizes), dtype=torch.int32,
                             device=self.device),
                torch.tensor(self.sizes, device=self.device),
                output_size=sum(self.sizes))
        return vec.index_select(0, self._segment)


class Layouts(dict):
    """Layouts by the identity of their lists of tensors, each made once
    (a Layout holds its tensors, so their ids are not reused meanwhile)."""

    def of(self, tensors: list) -> Layout:
        key = tuple(map(id, tensors))
        lay = self.get(key)
        if lay is None:
            lay = self[key] = Layout(tensors)
        return lay


class _GuardedOptimizer(torch.optim.Optimizer):
    """The shared step: gates, clip, the list-wise update, the guarded
    copy back."""

    def __init__(self, params, defaults: dict, learning_rate,
                 grad_clip_norm: Optional[float]):
        super().__init__(params, defaults)
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self._sharded: set = set()
        self._shard_group = None
        self._layouts = Layouts()
        # the group being updated: its live tensors' layout, and which of
        # them are sharded (a bool vector on the device; None: none is)
        self._lay: Optional[Layout] = None
        self._shard_mask: Optional[torch.Tensor] = None
        # after a clip, the clipped gradient's per-tensor sums of squares
        self._g_sq: Optional[torch.Tensor] = None

    def tensor_parallel(self, sharded_params, group) -> None:
        """Mark `sharded_params` as this rank's slices of tensors split
        over `group`: every per-tensor norm of them (Novograd's second
        moment and LUC, LAMB's and LARC's trust ratios, the clipping
        norm) is then taken over the whole tensor by an all-reduce of the
        sums of squares."""
        self._sharded = {id(p) for p in sharded_params}
        self._shard_group = group

    def _norm_vector(self, flat: torch.Tensor) -> torch.Tensor:
        """Each live tensor's norm in `flat` (laid out as the live
        tensors), in a persistent vector that the next call overwrites."""
        lay = self._lay
        return lay.load("norms", torch._foreach_norm(
            lay.split("split", flat), dtype=torch.float32), scalars=True)

    def _sq_norms(self, flat: torch.Tensor) -> torch.Tensor:
        """Each live tensor's sum of squares in `flat`, one entry a
        tensor (of the whole tensor where it is sharded)."""
        return _sum_shards(torch.square(self._norm_vector(flat)),
                           self._shard_mask, self._shard_group)

    def _grad_sq_norms(self, g: torch.Tensor) -> torch.Tensor:
        """`_sq_norms` of the step's gradient `g`: after a clip, the
        clip's own sums times the factor squared (equal but for
        rounding), so one `torch._foreach_norm` serves both."""
        return self._sq_norms(g) if self._g_sq is None else self._g_sq

    def _norms(self, flat: torch.Tensor) -> torch.Tensor:
        if self._shard_mask is None:
            return self._norm_vector(flat).clone()
        return torch.sqrt(self._sq_norms(flat))

    def _lr(self, step: torch.Tensor):
        lr = self.learning_rate
        return lr(step) if callable(lr) else lr

    def _init_state(self, p: torch.Tensor) -> dict:
        raise NotImplementedError

    def _update(self, p, g, state: dict, group: dict, count: torch.Tensor):
        """The update of the group's live tensors, each argument and
        result laid end to end (`state`: {state key: old values}) ->
        (new parameters, {state key: new values}). `_sq_norms`, `_norms`
        and `self._lay.expand` give and spread the per-tensor
        quantities."""
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
            live = [i for i, p in enumerate(group["params"])
                    if p.grad is not None]
            if not live:
                continue
            params = [group["params"][i] for i in live]
            states = [self.state[p] for p in params]
            for p, state in zip(params, states):
                if not state:
                    state.update(self._init_state(p))
            tracing.count("optim.multi_tensor", len(params))
            lay = self._lay = self._layouts.of(params)
            self._shard_mask = None
            if self._sharded:
                sharded = [id(p) in self._sharded for p in params]
                if any(sharded):
                    self._shard_mask = torch.tensor(sharded,
                                                    device=count.device)
            p_old = lay.load("p", params)
            g = lay.load("g", [p.grad for p in params])
            steps = _unfreeze_steps(group, live)
            if steps is not None:
                thawed = self._lay.expand(count >= torch.tensor(
                    steps, dtype=count.dtype, device=count.device))
                g = torch.where(thawed, g, 0.0)
            self._g_sq = None
            if self.grad_clip_norm:
                sq = self._sq_norms(g)
                # 1 where the norm is under the limit (or 0), else limit/norm
                factor = torch.clamp(
                    self.grad_clip_norm / torch.sqrt(sq.sum()), max=1.0)
                g = g * factor
                self._g_sq = sq * torch.square(factor)
            lists = {k: [s[k] for s in states] for k in states[0]}
            scalars = {k: lay.holds_scalars(k, v) for k, v in lists.items()}
            old = {k: lay.load(k, v, scalars[k]) for k, v in lists.items()}
            p_new, new = self._update(p_old, g, old, group, count)
            if steps is not None:
                p_new = torch.where(thawed, p_new, p_old)
            lay.store(params, p_new, p_old, finite)
            for k, value in new.items():
                lay.store(lists[k], value, old[k], finite, scalars[k])
            count.add_(1 if finite is None else finite)
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
        v = state["exp_avg_sq"]
        norm_sq = self._grad_sq_norms(g)
        v_new = torch.where(v == 0, norm_sq, beta2 * v + (1 - beta2) * norm_sq)
        g_hat = g / self._lay.expand(torch.sqrt(v_new) + group["eps"])
        if group["weight_decay"]:
            g_hat = g_hat + group["weight_decay"] * p
        if group["grad_averaging"]:
            g_hat = g_hat * (1 - beta1)
        m_new = beta1 * state["exp_avg"] + g_hat
        if group["luc"]:
            factor = group["luc_trust"] * self._norms(p) \
                / (self._norms(m_new) + group["luc_eps"])
            update = self._lay.expand(-torch.clamp(factor, max=lr)) * m_new
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
        ratio = trust_ratio(self._norms(p), self._norms(u))
        return u * self._lay.expand(ratio)


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
            ratio = trust_ratio(self._norms(p), self._norms(g),
                                group["larc_eta"])
            g = g * self._lay.expand(ratio)
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
