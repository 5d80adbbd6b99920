"""Corpus-level WER/CER (the port's copy of vietasr_tpu/train/metrics.py).

Reference: word_error_rate / __levenshtein
(nemo/collections/asr/metrics.py) — corpus WER is
sum(edit distances) / sum(reference word counts). The Levenshtein here is a
numpy DP (two-row) rather than a Python list loop.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance via a vectorized two-row DP."""
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if n > m:
        a, b = b, a
        n, m = m, n
    a_arr = np.asarray([hash(x) for x in a])
    b_arr = np.asarray([hash(x) for x in b])
    current = np.arange(n + 1)
    for i in range(1, m + 1):
        previous = current
        current = np.empty(n + 1, dtype=np.int64)
        current[0] = i
        sub = previous[:-1] + (a_arr != b_arr[i - 1])
        # delete cost depends on current[j-1] — do the scan in one pass
        ins = previous[1:] + 1
        best = np.minimum(sub, ins)
        running = current[0]
        for j in range(n):
            running = min(running + 1, best[j])
            current[j + 1] = running
    return int(current[n])


def word_error_rate(hypotheses: List[str], references: List[str],
                    use_cer: bool = False) -> float:
    """Corpus WER (or CER): sum of edits over sum of reference tokens."""
    if len(hypotheses) != len(references):
        raise ValueError(
            f"hypotheses ({len(hypotheses)}) and references "
            f"({len(references)}) must have the same length")
    edits = 0
    tokens = 0
    for h, r in zip(hypotheses, references):
        h_list = list(h) if use_cer else h.split()
        r_list = list(r) if use_cer else r.split()
        tokens += len(r_list)
        edits += levenshtein(h_list, r_list)
    return 1.0 * edits / tokens if tokens else float("inf")
