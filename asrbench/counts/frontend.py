"""The log-mel kernel (csrc/frontend.cu): one launch a forward over the
padded batch. Its least time is the larger of its bytes (the padded
waveform, the lengths, the log-mel and the per-tile (sum, M2) partials,
the constants, each once) at the HBM rate and a real FFT's operations per
frame (2.5 n log2 n) plus the power (3 a bin), the mel's nonzero taps (2
each) and the log, guard and partials (4 a mel), at the fp32 rate."""

from __future__ import annotations

import math

import numpy as np

from asrbench import peaks
from asrbench.reference.logmel import mel_filterbank

TILE_FRAMES = 16          # frames a partials tile covers


def shape(fcfg: dict, samples: int):
    """(padded input samples, output frames padded to pad_to, tiles) of a
    row of `samples` (a bucket's length)."""
    n_fft = fcfg["n_fft"]
    hop = int(fcfg["window_stride"] * fcfg["sample_rate"])
    frames = samples // hop + 1
    t_out = -(-frames // fcfg["pad_to"]) * fcfg["pad_to"]
    return samples + n_fft, t_out, -(-t_out // TILE_FRAMES)


def launch(fcfg: dict, rows: int, samples: int):
    """(least seconds, operations, bytes) of one launch over `rows` rows
    of `samples`."""
    n_fft, n_mels = fcfg["n_fft"], fcfg["features"]
    nb = n_fft // 2 + 1
    sp, t_out, tiles = shape(fcfg, samples)
    taps = int((mel_filterbank(fcfg["sample_rate"], n_fft, n_mels)
                .astype(np.float32) != 0).sum())
    frames = rows * t_out
    ops = frames * (2.5 * n_fft * math.log2(n_fft) + 3 * nb + 2 * taps
                    + 4 * n_mels)
    # window (fp32), twiddles (3/4 n complex fp64), packed mel taps
    const = 4 * n_fft + 16 * (3 * n_fft // 4) + 8 * taps + 4 * (n_mels + 1)
    nbytes = 4 * (rows * sp + rows + frames * n_mels
                  + rows * tiles * 2 * n_mels) + const
    return max(ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES), ops, nbytes
