"""The log-mel frontend, plain: pre-emphasis, reflect padding, a Hann-
windowed real FFT per frame in float64, power, a Slaney mel filterbank,
log with an additive guard, per-feature normalization over each row's
valid frames (two-pass, Bessel's correction, a guard on the std), zero
past the valid frames, time padded to a multiple of `pad_to`.

Written from the featurizer's published semantics (NeMo's
AudioToMelSpectrogramPreprocessor with `normalize: per_feature`), in
float64 so that it stands above any float32 chain; the result is cast to
float32. It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LOG_GUARD = 2.0 ** -24
STD_GUARD = 1e-5

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ)
                                          / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(
                        m, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
                    _F_SP * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float64 Slaney filterbank (librosa's
    defaults: htk=False, norm="slaney"), 0 Hz to sr / 2."""
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]


def window(win_length: int, n_fft: int) -> np.ndarray:
    """Symmetric Hann of win_length samples, centred in n_fft zeros."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    full = np.zeros(n_fft)
    pad = (n_fft - win_length) // 2
    full[pad:pad + win_length] = w
    return full


def seq_len(lengths: torch.Tensor, hop: int) -> torch.Tensor:
    """Valid frames of each row: ceil(samples / hop)."""
    return torch.div(lengths.to(torch.int64) + hop - 1, hop,
                     rounding_mode="floor").to(torch.int32)


def log_mel(signal: torch.Tensor, lengths: torch.Tensor, fcfg: dict):
    """(B, S) waveform + (B,) sample counts -> (features (B, T, n_mels)
    float32 with T the frames padded to pad_to, seq_len (B,) int32)."""
    sr = fcfg["sample_rate"]
    hop = int(fcfg["window_stride"] * sr)
    win = int(fcfg["window_size"] * sr)
    n_fft = fcfg["n_fft"]
    n_mels = fcfg["features"]
    dev = signal.device
    x = signal.to(torch.float64)
    x = torch.cat([x[:, :1], x[:, 1:] - 0.97 * x[:, :-1]], dim=1)
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop) * torch.as_tensor(window(win, n_fft),
                                                        device=dev)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    mel = power @ torch.as_tensor(mel_filterbank(sr, n_fft, n_mels).T,
                                  device=dev)
    mel = torch.log(mel + LOG_GUARD)
    sl = seq_len(lengths, hop)
    t = mel.shape[1]
    mask = (torch.arange(t, device=dev)[None, :] < sl[:, None])[..., None]
    n = torch.clamp_min(sl, 2).to(torch.float64)[:, None]
    mean = (mel * mask).sum(dim=1) / n
    var = (((mel - mean[:, None]) * mask) ** 2).sum(dim=1) / (n - 1.0)
    mel = (mel - mean[:, None]) / (torch.sqrt(var) + STD_GUARD)[:, None]
    mel = torch.where(mask, mel, torch.zeros_like(mel))
    t_pad = -(-t // fcfg["pad_to"]) * fcfg["pad_to"]
    mel = F.pad(mel, (0, 0, 0, t_pad - t))
    return mel.to(torch.float32), sl
