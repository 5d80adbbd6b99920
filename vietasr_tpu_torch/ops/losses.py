"""Common losses beyond CTC (counterpart of vietasr_tpu/ops/losses.py):
softmax cross entropy with optional per-example weights, the masked
sequence NLL with label smoothing, MSE and a weighted sum of losses. They
back the classification head (models/classifier.py) and the attention
decoder (models/seq2seq.py)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean softmax cross entropy over int `labels`; with `weights`, the
    weighted sum over max(sum(weights), 1e-9)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if weights is not None:
        return torch.sum(nll * weights) / torch.clamp_min(
            torch.sum(weights), 1e-9)
    return torch.mean(nll)


def sequence_loss(log_probs: torch.Tensor, targets: torch.Tensor,
                  lengths: torch.Tensor, *, pad_id: int = 0,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Token NLL over padded (B, T, V) log-probs, averaged over the
    positions inside `lengths` whose target is not `pad_id`; label
    smoothing mixes in -mean(log_probs) over the vocabulary."""
    t = log_probs.shape[1]
    nll = -torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    if smoothing > 0:
        uniform = -torch.mean(log_probs, dim=-1)
        nll = (1 - smoothing) * nll + smoothing * uniform
    mask = torch.arange(t, device=log_probs.device)[None, :] \
        < lengths.to(log_probs.device)[:, None]
    mask = (mask & (targets != pad_id)).to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1)


def mse_loss(predictions: torch.Tensor, targets: torch.Tensor
             ) -> torch.Tensor:
    return torch.mean((predictions - targets) ** 2)


def aggregate_losses(losses: Sequence[torch.Tensor],
                     weights: Optional[Sequence[float]] = None
                     ) -> torch.Tensor:
    """Weighted sum of losses (all weights 1 by default)."""
    if weights is None:
        weights = [1.0] * len(losses)
    total = torch.zeros(())
    for loss, w in zip(losses, weights):
        total = total + w * loss
    return total
