"""Synthetic data backends for framework tests and smoke training (the
port's copy of vietasr_tpu/train/synthetic.py).

Reference: ZerosDataLayer + neuralType2TensorShape
(nemo/backends/pytorch/common/zero_data.py) — the framework's only
mock/fixture infrastructure (SURVEY.md §4): it lets a full training graph
run without real data. Here:

- `zeros_batch`: shape-only batches (the direct equivalent).
- `SyntheticToneDataset`: learnable synthetic speech — tones whose
  frequencies encode the label sequence — so convergence tests have an
  actual signal (the analogue of the reference's TaylorNet toy models,
  tutorials/toys.py).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from vietasr_tpu_torch.audio.dataset import Batch


def zeros_batch(batch_size: int, *, seconds: float = 1.0,
                sample_rate: int = 16000, max_tokens: int = 8) -> Batch:
    n = int(seconds * sample_rate)
    return Batch(
        signal=np.zeros((batch_size, n), np.float32),
        signal_lens=np.full((batch_size,), n, np.int32),
        tokens=np.ones((batch_size, max_tokens), np.int32),
        token_lens=np.full((batch_size,), max_tokens, np.int32),
    )


class SyntheticToneDataset:
    """Tone sequences: label k (1-based) becomes a base_hz*k tone segment."""

    def __init__(self, *, num_labels: int = 3, seconds: float = 0.5,
                 tokens_per_utt: int = 3, sample_rate: int = 16000,
                 base_hz: float = 300.0, amplitude: float = 0.3,
                 seed: int = 0):
        self.num_labels = num_labels
        self.seconds = seconds
        self.tokens_per_utt = tokens_per_utt
        self.sample_rate = sample_rate
        self.base_hz = base_hz
        self.amplitude = amplitude
        self.rng = np.random.RandomState(seed)

    def batch(self, batch_size: int) -> Batch:
        n = int(self.seconds * self.sample_rate)
        t = np.arange(n) / self.sample_rate
        signal = np.zeros((batch_size, n), np.float32)
        tokens = np.zeros((batch_size, self.tokens_per_utt), np.int32)
        for i in range(batch_size):
            ids = self.rng.randint(1, self.num_labels + 1,
                                   size=self.tokens_per_utt)
            tokens[i] = ids
            seg = n // self.tokens_per_utt
            for j, lab in enumerate(ids):
                freq = self.base_hz * int(lab)
                signal[i, j * seg:(j + 1) * seg] = \
                    self.amplitude * np.sin(2 * np.pi * freq * t[:seg])
        return Batch(
            signal=signal,
            signal_lens=np.full((batch_size,), n, np.int32),
            tokens=tokens,
            token_lens=np.full((batch_size,), self.tokens_per_utt, np.int32),
        )

    def batches(self, batch_size: int, num_batches: int) -> Iterator[Batch]:
        for _ in range(num_batches):
            yield self.batch(batch_size)
