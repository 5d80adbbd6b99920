"""Mel filterbank construction (numpy, host-side, done once at model build).

The port's own copy of vietasr_tpu/frontend/mel.py: the Slaney-style mel
scale and filterbank that librosa.filters.mel produces with its defaults
(htk=False, norm="slaney").
- Slaney mel scale: linear below 1 kHz (mel = 3 f / 200), logarithmic above
  (step = log(6.4)/27 per mel).
- Triangular filters over `n_mels + 2` mel-spaced corner frequencies,
  evaluated on the FFT bin center frequencies.
- Slaney area normalization: each triangle scaled by 2 / (f[i+2] - f[i]).
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0           # Hz per mel in the linear region
_MIN_LOG_HZ = 1000.0          # linear/log boundary
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # mel step above the boundary


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    log_region = frequencies >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(frequencies, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Inverse Slaney mel scale."""
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank matrix of shape (n_mels, n_fft // 2 + 1)."""
    if fmax is None:
        fmax = sample_rate / 2.0

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)

    mel_corners = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_corners = mel_to_hz(mel_corners)

    fdiff = np.diff(hz_corners)
    # ramps[i, k] = hz_corners[i] - fft_freqs[k]
    ramps = hz_corners[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization
    enorm = 2.0 / (hz_corners[2 : n_mels + 2] - hz_corners[:n_mels])
    weights *= enorm[:, None]

    return weights.astype(dtype)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hann window (torch.hann_window(periodic=False) semantics)."""
    if win_length == 1:
        return np.ones(1, dtype=dtype)
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    return w.astype(dtype)
