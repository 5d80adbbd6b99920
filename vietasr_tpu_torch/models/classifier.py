"""Speech classification head (counterpart of
vietasr_tpu/models/classifier.py): a masked average or max pool of the
encoder's (B, T, C) output over each row's valid frames, then a linear
layer; and top-k accuracy."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vietasr_tpu_torch.models.layers import (length_mask, symmetric_uniform,
                                             xavier_uniform)


def init_classifier_head(generator: Optional[torch.Generator], feat_in: int,
                         num_classes: int, *, device=None) -> dict:
    """{"w": xavier (feat_in, num_classes), "b": U(+-feat_in^-0.5)} drawn
    from `generator`."""
    return {
        "w": xavier_uniform(generator, (feat_in, num_classes), feat_in,
                            num_classes, device=device),
        "b": symmetric_uniform(generator, (num_classes,), feat_in ** -0.5,
                               device=device),
    }


def classifier_apply(head: dict, encoded: torch.Tensor,
                     enc_lens: torch.Tensor, *, pooling: str = "avg",
                     return_logits: bool = True) -> torch.Tensor:
    """encoded (B, T, C) -> (B, num_classes) logits, or their softmax. The
    average divides by max(len, 1); the max takes valid frames only (a row
    of length 0 pools to -inf)."""
    mask = length_mask(encoded.shape[1], enc_lens, encoded.dtype)
    if pooling == "avg":
        denom = torch.clamp_min(enc_lens.to(encoded.dtype), 1.0)[:, None]
        pooled = torch.sum(encoded * mask, dim=1) / denom
    elif pooling == "max":
        pooled = torch.amax(torch.where(
            mask > 0, encoded, torch.full_like(encoded, -torch.inf)), dim=1)
    else:
        raise ValueError("pooling must be 'avg' or 'max'")
    logits = pooled @ head["w"] + head["b"]
    if return_logits:
        return logits
    return torch.softmax(logits, dim=-1)


def classification_accuracy(logits, targets, top_k=(1,)) -> Tuple[float, ...]:
    """Top-k accuracies. Classes are ranked as the JAX package ranks them,
    by a stable ascending sort reversed: among equal logits the higher
    index ranks first."""
    logits = torch.as_tensor(logits)
    targets = torch.as_tensor(targets, device=logits.device)
    order = torch.flip(torch.argsort(logits, dim=1, stable=True), dims=(1,))
    out = []
    for k in top_k:
        correct = torch.any(order[:, :k] == targets[:, None], dim=1)
        out.append(float(torch.mean(correct.to(torch.float32))))
    return tuple(out)
