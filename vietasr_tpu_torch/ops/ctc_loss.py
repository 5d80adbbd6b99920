"""CTC loss as a log-semiring alpha recursion (counterpart of
vietasr_tpu/ops/ctc_loss.py).

The reference wraps nn.CTCLoss(blank=num_classes, reduction='none') and
takes a plain batch mean without normalizing by target length; these are
the same semantics: the extended lattice [b, y1, b, y2, ..., b], the s-2
skip gated by `can_skip`, rows frozen past each input length, the
NEG = -1e30 sentinel (an infeasible row's loss is ~1e30, finite).

Routes (`impl`):
  - "plain": the JAX `impl="scan"` recursion, a Python loop over T whose
    gradient autograd takes through the loop;
  - "kernel": the CUDA alpha/beta kernel pair behind an autograd Function
    (ops/fused_ctc.py; its plain version for CPU tensors), the counterpart
    of JAX's `impl="pallas"`;
  - "auto": "kernel" for CUDA tensors, "plain" for CPU tensors.

The emission lookup stays outside the recursion, as in JAX: an fp32
product with the one-hot extended labels, whose transpose (the backward)
is the same product again. It is exact in fp32 (each output sums one
product with 1 and zeros) and deterministic, where `gather`'s CUDA
backward would sum the L+1 blank positions with atomics in a different
order each run; so it refuses TF32, which would round the log-probs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vietasr_tpu_torch.ops.fused_ctc import NEG, ctc_alpha_plain, ctc_neg_ll
from vietasr_tpu_torch.utils.typing import assert_labels, assert_log_probs

CTC_IMPLS = ("auto", "kernel", "plain")


def _extend_targets(targets: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, L) -> (B, 2L+1) interleaved with blanks: [b, y1, b, y2, ..., b]."""
    b, l = targets.shape
    ext = torch.full((b, 2 * l + 1), blank, dtype=targets.dtype,
                     device=targets.device)
    ext[:, 1::2] = targets
    return ext


def lattice_masks(targets: torch.Tensor, target_lengths: torch.Tensor,
                  blank: int):
    """(ext, can_skip, valid_s), each (B, 2L+1): the extended labels, where
    alpha may arrive from s-2 (a label differing from the one two back),
    and which positions lie on each row's lattice (s < 2 * len + 1)."""
    ext = _extend_targets(targets.to(torch.int64), blank)
    s = ext.shape[1]
    ext_shift2 = F.pad(ext, (2, 0), value=-1)[:, :s]
    can_skip = (ext != blank) & (ext != ext_shift2)
    pos = torch.arange(s, device=ext.device)[None, :]
    valid_s = pos < (2 * target_lengths.to(torch.int64)[:, None] + 1)
    return ext, can_skip, valid_s


def emission_lookup(log_probs: torch.Tensor, ext: torch.Tensor
                    ) -> torch.Tensor:
    """(B, T, V) log-probs -> (B, T, S) log-probs of the extended labels,
    as the fp32 product with their one-hot rows (labels outside [0, V)
    give zero rows, as jax.nn.one_hot does)."""
    if log_probs.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "ctc_loss: the emission lookup needs full-fp32 matmuls; set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    v = log_probs.shape[2]
    one_hot = (ext[:, :, None] == torch.arange(v, device=ext.device)
               ).to(log_probs.dtype)                          # (B, S, V)
    return torch.matmul(log_probs, one_hot.transpose(1, 2))


def _alpha_scan_neg_ll(lp_ext, can_skip, valid_s, input_lengths,
                       target_lengths) -> torch.Tensor:
    """JAX's `impl="scan"`: the kernel pair's plain alpha recursion, whose
    gradient autograd takes through the loop over T, then the lse of the
    two end states without `final_ll`'s sentinel clamp (as in JAX, an
    infeasible row keeps the gradient of its unclamped lse)."""
    alpha = ctc_alpha_plain(lp_ext, can_skip, valid_s, input_lengths)[:, -1]
    tl = target_lengths.to(torch.int64)
    end_blank = alpha.gather(1, (2 * tl)[:, None])[:, 0]
    idx_label = torch.clamp_min(2 * tl - 1, 0)
    end_label = alpha.gather(1, idx_label[:, None])[:, 0]
    end_label = torch.where(tl > 0, end_label, torch.full_like(end_label, NEG))
    m = torch.maximum(end_blank, end_label)
    return -(m + torch.log(torch.exp(end_blank - m) + torch.exp(end_label - m)))


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             input_lengths: torch.Tensor, target_lengths: torch.Tensor, *,
             blank: int, reduction: str = "mean_batch", impl: str = "auto"
             ) -> torch.Tensor:
    """Negative log-likelihood of the CTC alignment marginal.

    log_probs: (B, T, V) log-softmax outputs; targets: (B, L) int labels
    (padded arbitrarily beyond target_lengths); input_lengths,
    target_lengths: (B,) int; blank: the blank id (== num_classes here).
    reduction: "none" | "mean_batch" (the reference's batch mean) | "mean"
    (normalized by target length, then averaged). impl: "auto" | "kernel" |
    "plain" (see the module docstring). Returns a scalar, or (B,) for
    reduction="none"."""
    assert_log_probs(log_probs, num_classes=blank, port="ctc_loss.log_probs")
    assert_labels(targets, target_lengths, port="ctc_loss.targets")
    if impl not in CTC_IMPLS:
        raise ValueError(f"impl must be one of {CTC_IMPLS}, got {impl!r}")
    if reduction not in ("none", "mean_batch", "mean"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if impl == "auto":
        impl = "kernel" if log_probs.is_cuda else "plain"
    ext, can_skip, valid_s = lattice_masks(targets, target_lengths, blank)
    lp_ext = emission_lookup(log_probs, ext)
    neg_ll = ctc_neg_ll if impl == "kernel" else _alpha_scan_neg_ll
    loss = neg_ll(lp_ext, can_skip, valid_s, input_lengths, target_lengths)
    if reduction == "none":
        return loss
    if reduction == "mean_batch":
        return torch.mean(loss)
    return torch.mean(loss / torch.clamp_min(target_lengths, 1))
