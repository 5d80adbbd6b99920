"""The static-shape batch (the port's copy of `Batch` from
vietasr_tpu/audio/dataset.py). The dataset and the bucketing batcher wait
for a later slice (ROADMAP A.8)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Batch:
    """One static-shape batch. `signal` is zero-padded to the bucket length;
    real lengths ride along for masking (never recomputed downstream)."""

    signal: np.ndarray        # (B, S_bucket) float32
    signal_lens: np.ndarray   # (B,) int32
    tokens: np.ndarray        # (B, L_max) int32
    token_lens: np.ndarray    # (B,) int32

    @property
    def audio_seconds(self) -> float:
        return float(self.signal_lens.sum())
