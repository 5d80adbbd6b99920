"""The train step, plain: the log-mel of the dithered waveform, the
encoder in training mode (asrbench/reference/quartznet.py), the CTC loss
by `torch.nn.functional.ctc_loss` averaged over the rows that have audio
and a finite loss, the gradient by autograd, and a frozen Novograd
(Ginsburg et al. 2019, arXiv:1905.11286) in NeMo's order of operations:
the gradients clipped by their global norm, a per-tensor second moment
bootstrapped by the first gradient's squared norm, the gradient divided by
its root, weight decay added after that, the first moment, the update
-lr * m.

Everything here is float32 (the caller turns TF32 off), or, with `quant`,
each convolution's operands rounded first (the control). It imports
nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from asrbench.reference import logmel, quartznet


def flat_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"encoder/0/sub/0/dw_w": leaf, ...} of a nested dict / list tree, in
    its own order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flat_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def loss_and_grads(params: dict, stats: dict, batch: dict, noise: torch.Tensor,
                   model: dict, *, quant: Optional[Callable] = None):
    """(loss, {path: gradient}) of one batch: batch holds the waveform
    (B, S), its sample counts, the token ids (B, L) and their counts, as
    numpy arrays; `noise` the (B, S) standard normals of the dither."""
    dev = noise.device
    sig = torch.as_tensor(batch["signal"], device=dev)
    slen = torch.as_tensor(batch["signal_lens"], device=dev)
    tokens = torch.as_tensor(batch["tokens"], device=dev).to(torch.int64)
    tlen = torch.as_tensor(batch["token_lens"], device=dev).to(torch.int64)
    fcfg = model["featurizer"]
    feats, flen = logmel.log_mel(sig + fcfg["dither"] * noise, slen, fcfg)
    leaves = flat_leaves(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    lp, olen = quartznet.forward({"params": params, "batch_stats": stats},
                                 feats, flen, model["blocks"], training=True,
                                 quant=quant)
    per_row = F.ctc_loss(lp.transpose(0, 1), tokens, olen.to(torch.int64),
                         tlen, blank=len(model["labels"]), reduction="none",
                         zero_infinity=False)
    valid = (slen > 0) & torch.isfinite(per_row) & (per_row < 1e25)
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    loss = per_row.sum() / torch.clamp_min(valid.sum(), 1)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for leaf in leaves.values():
        leaf.requires_grad_(False)
    return loss.detach(), dict(zip(leaves, grads))


class Novograd:
    """The frozen optimizer over a {path: parameter} dict (updated in
    place); `first_norms` keeps each tensor's first gradient norm, after
    clipping, as the second moment holds it."""

    def __init__(self, lr: float, betas=(0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip_norm: float = 0.0):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.wd, self.clip = weight_decay, grad_clip_norm
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.first_norms: Dict[str, float] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if norm >= self.clip:
                grads = {k: g / norm * self.clip for k, g in grads.items()}
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k]
            sq = torch.sum(g * g)
            if k not in self.v:
                self.v[k] = sq
                self.m[k] = torch.zeros_like(p)
                self.first_norms[k] = float(torch.sqrt(sq))
            else:
                self.v[k] = b2 * self.v[k] + (1 - b2) * sq
            g_hat = g / (torch.sqrt(self.v[k]) + self.eps)
            if self.wd:
                g_hat = g_hat + self.wd * p
            self.m[k] = b1 * self.m[k] + g_hat
            p.add_(-self.lr * self.m[k])


def run_steps(variables: dict, batches: List[dict], noises: List[torch.Tensor],
              model: dict, opt: dict, *, quant: Optional[Callable] = None):
    """The first len(batches) steps from `variables` (copied). Returns
    (losses, first gradient norms {path: norm}, parameter change norms
    {path: norm} after the last step, reference gradient norms of the
    first step before clipping {path: norm})."""
    params = _copy_tree(variables["params"])
    stats = variables["batch_stats"]["encoder"]
    stats = {"encoder": _copy_tree(stats)}
    leaves = flat_leaves(params)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    nov = Novograd(opt["lr"], tuple(opt["betas"]), opt["eps"],
                   opt["weight_decay"], opt["grad_clip_norm"])
    losses, raw = [], {}
    for i, (batch, noise) in enumerate(zip(batches, noises)):
        loss, grads = loss_and_grads(params, stats, batch, noise, model,
                                     quant=quant)
        if i == 0:
            raw = {k: float(torch.linalg.norm(g)) for k, g in grads.items()}
        losses.append(float(loss))
        nov.step(leaves, grads)
        # BN's running statistics do not enter a training-mode forward, so
        # the steps compared need no update of them
    change = {k: float(torch.linalg.norm(leaves[k] - start[k]))
              for k in leaves}
    return losses, nov.first_norms, change, raw


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree.detach().to(torch.float32).clone()
