"""Greedy CTC decoding (counterpart of vietasr_tpu/ops/greedy.py).

Device side: argmax over the class dim plus a "keep" mask (not a repeat of
the previous frame, not blank, within the valid length). Host side: the
collapse of the already-masked frames into label strings.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vietasr_tpu_torch.utils.typing import assert_log_probs


def greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor, *,
                  blank: int):
    """(B, T, V) log-probs -> (preds (B, T) int32, keep (B, T) bool).

    Ties go to the first index, as `jnp.argmax` does. keep[b, t] is True
    for frames that survive CTC collapse."""
    assert_log_probs(log_probs, num_classes=blank,
                     port="greedy_decode.log_probs")
    # torch.argmax picks the first maximal index on CPU and CUDA alike
    preds = torch.argmax(log_probs, dim=-1).to(torch.int32)
    prev = F.pad(preds, (1, 0), value=-1)[:, :-1]
    t = preds.shape[1]
    valid = (torch.arange(t, device=preds.device)[None, :]
             < lengths.to(preds.device)[:, None])
    keep = (preds != prev) & (preds != blank) & valid
    return preds, keep


def collapse_batch(preds, keep) -> List[np.ndarray]:
    """Host-side gather of kept frames -> per-utterance label id arrays."""
    preds = preds.cpu().numpy() if torch.is_tensor(preds) else preds
    keep = keep.cpu().numpy() if torch.is_tensor(keep) else keep
    return [p[k] for p, k in zip(np.asarray(preds), np.asarray(keep))]


def ids_to_text(ids: Sequence[int], labels: Sequence[str]) -> str:
    return "".join(labels[i] for i in ids)


def ctc_collapse(pred_ids: Sequence[int], *, blank: int,
                 prev: Optional[int] = None) -> List[int]:
    """Plain collapse of a raw (uncollapsed) argmax sequence. `prev`
    carries the last frame across chunk boundaries."""
    out: List[int] = []
    for p in pred_ids:
        if p != prev and p != blank:
            out.append(int(p))
        prev = p
    return out
