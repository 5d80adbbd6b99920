"""Log-mel spectrogram frontend, plain PyTorch (counterpart of
vietasr_tpu/frontend/features.py::log_mel_features).

  dither (training only) -> preemphasis (0.97) -> reflect pad n_fft//2 ->
  framing (hop 160) -> windowed real-DFT matmul in IEEE fp32 -> |X|^2 ->
  mel matmul (Slaney 64 bins) -> log(x + 2^-24) -> per-feature masked
  mean/std normalization (two-pass, Bessel, +1e-5 on the std) -> zero
  beyond seq_len -> pad time to a multiple of pad_to.

The DFT runs as a matmul against the same fp32 windowed DFT matrix the JAX
package builds (numpy float64, cast to fp32). It must stay full fp32: the
DFT has heavy cancellation and log() turns TF32/bf16 damage into O(1)
feature error, so callers on the GPU keep
`torch.backends.cuda.matmul.allow_tf32` False (PyTorch's default).

Layout is (B, T, n_mels), channels last, as the encoder consumes it.
`causal_per_feature`/`all_features` normalization and frame splicing wait
for the slices that need them.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vietasr_tpu_torch.frontend.mel import hann_window, mel_filterbank
from vietasr_tpu_torch.utils.device import resolve_device
from vietasr_tpu_torch.utils.typing import assert_audio_batch

LOG_ZERO_GUARD = 2.0 ** -24
STD_GUARD = 1e-5


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    """The YAML section `AudioToMelSpectrogramPreprocessor`."""

    sample_rate: int = 16000
    window_size: float = 0.02
    window_stride: float = 0.01
    window: str = "hann"
    normalize: str = "per_feature"
    n_fft: Optional[int] = 512
    preemph: Optional[float] = 0.97
    features: int = 64
    lowfreq: float = 0.0
    highfreq: Optional[float] = None
    log: bool = True
    log_zero_guard_type: str = "add"
    log_zero_guard_value: float = LOG_ZERO_GUARD
    dither: float = 1e-5
    pad_to: int = 16
    frame_splicing: int = 1
    pad_value: float = 0.0
    mag_power: float = 2.0
    # accepted for config compatibility; the DFT-matmul path ignores it
    stft_conv: bool = False

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)

    @property
    def fft_length(self) -> int:
        return self.n_fft or 2 ** math.ceil(math.log2(self.win_length))

    @classmethod
    def from_dict(cls, d: dict) -> "FeaturizerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def feature_seq_len(sample_len: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Number of valid feature frames: ceil(len / hop), computed in float32
    exactly as the JAX package does."""
    return torch.ceil(sample_len.to(torch.float32) / hop_length).to(torch.int32)


def _windowed_dft_matrix(cfg: FeaturizerConfig) -> np.ndarray:
    """(n_fft, 2 * n_bins) fp32: frames @ M yields [real | imag] of the
    one-sided DFT of the windowed frame. The window is zero-padded to n_fft
    centered, as torch.stft does for win_length < n_fft."""
    n_fft = cfg.fft_length
    n_bins = n_fft // 2 + 1
    if cfg.window == "hann":
        win = hann_window(cfg.win_length, dtype=np.float64)
    elif cfg.window in (None, "none", "ones"):
        win = np.ones(cfg.win_length, dtype=np.float64)
    else:
        raise ValueError(f"unsupported window: {cfg.window!r}")
    pad = (n_fft - cfg.win_length) // 2
    win_full = np.zeros(n_fft, dtype=np.float64)
    win_full[pad : pad + cfg.win_length] = win

    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_m = np.cos(ang) * win_full[:, None]
    sin_m = -np.sin(ang) * win_full[:, None]
    return np.concatenate([cos_m, sin_m], axis=1).astype(np.float32)


def _mel_matrix(cfg: FeaturizerConfig) -> np.ndarray:
    """(n_bins, n_mels) fp32 — the transposed mel filterbank."""
    return np.ascontiguousarray(
        mel_filterbank(cfg.sample_rate, cfg.fft_length, cfg.features,
                       cfg.lowfreq, cfg.highfreq).T, np.float32)


def preemphasize_and_pad(x: torch.Tensor, cfg: FeaturizerConfig
                         ) -> torch.Tensor:
    """(B, S) fp32 -> (B, S + n_fft) pre-emphasized, reflect-padded by
    n_fft//2 on both sides (torch.stft center=True framing)."""
    if cfg.preemph is not None:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)
    pad = cfg.fft_length // 2
    return F.pad(x, (pad, pad), mode="reflect")


def log_guard(mel: torch.Tensor, cfg: FeaturizerConfig) -> torch.Tensor:
    if cfg.log_zero_guard_type == "add":
        return torch.log(mel + cfg.log_zero_guard_value)
    if cfg.log_zero_guard_type == "clamp":
        return torch.log(torch.clamp_min(mel, cfg.log_zero_guard_value))
    raise ValueError(f"bad log_zero_guard_type {cfg.log_zero_guard_type!r}")


def _normalize(x: torch.Tensor, seq_len: torch.Tensor,
               normalize_type: str) -> torch.Tensor:
    """Masked per-feature normalization over valid frames: two-pass mean
    and unbiased (n-1) variance with n = max(seq_len, 2), +1e-5 std guard."""
    if not normalize_type:
        return x
    if normalize_type != "per_feature":
        raise NotImplementedError(
            f"normalize={normalize_type!r} is not ported yet")
    t = x.shape[1]
    mask = (torch.arange(t, device=x.device)[None, :]
            < seq_len[:, None]).to(x.dtype)[:, :, None]         # (B, T, 1)
    n = torch.clamp_min(seq_len, 2).to(x.dtype)[:, None]        # (B, 1)
    mean = torch.sum(x * mask, dim=1) / n                       # (B, D)
    var = torch.sum(((x - mean[:, None, :]) * mask) ** 2, dim=1) / (n - 1.0)
    std = torch.sqrt(var) + STD_GUARD
    return (x - mean[:, None, :]) / std[:, None, :]


def mask_and_pad_time(feats: torch.Tensor, seq_len: torch.Tensor, t_out: int,
                      cfg: FeaturizerConfig) -> torch.Tensor:
    """Zero (pad_value) beyond seq_len, then trim/pad time to the pad_to
    grid over the t_out real frames."""
    t = feats.shape[1]
    keep = (torch.arange(t, device=feats.device)[None, :, None]
            < seq_len[:, None, None])
    feats = torch.where(keep, feats, torch.full_like(feats, cfg.pad_value))
    t_final = -(-t_out // cfg.pad_to) * cfg.pad_to if cfg.pad_to > 0 \
        else t_out
    if t_final <= t:
        return feats[:, :t_final]
    return F.pad(feats, (0, 0, 0, t_final - t), value=cfg.pad_value)


def log_mel_features(
    signal: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cfg: FeaturizerConfig,
    dft_matrix: torch.Tensor,
    mel_matrix: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
):
    """(B, S) float waveform + (B,) int lengths ->
    (feats (B, T_padded, n_mels) fp32, seq_len (B,) int32)."""
    assert_audio_batch(signal, lengths, port="featurizer.input_signal")
    if cfg.frame_splicing != 1:
        raise NotImplementedError("frame_splicing > 1 is not ported yet")
    hop = cfg.hop_length
    n_fft = cfg.fft_length
    seq_len = feature_seq_len(lengths, hop)

    x = signal.to(torch.float32)
    if cfg.dither > 0 and training:
        x = x + cfg.dither * torch.randn(x.shape, generator=generator,
                                         device=x.device, dtype=x.dtype)
    xp = preemphasize_and_pad(x, cfg)
    frames = xp.unfold(1, n_fft, hop)                           # (B, T, n_fft)
    spec = torch.matmul(frames, dft_matrix)                     # (B, T, 2*nb)
    n_bins = n_fft // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    power = re * re + im * im
    if cfg.mag_power != 2.0:
        # |X|^p, as the JAX package computes it for p != 2
        power = torch.pow(torch.sqrt(torch.clamp_min(power, 0.0)),
                          cfg.mag_power)
    mel = torch.matmul(power, mel_matrix)                       # (B, T, n_mels)
    if cfg.log:
        mel = log_guard(mel, cfg)
    mel = _normalize(mel, seq_len, cfg.normalize)
    return mask_and_pad_time(mel, seq_len, mel.shape[1], cfg), seq_len


def make_featurizer(cfg: FeaturizerConfig, *, device=None):
    """Bind the constant DFT/mel matrices on `device` and return
    featurize(signal, lengths, ...)."""
    dev = resolve_device(device)
    dft = torch.as_tensor(_windowed_dft_matrix(cfg), device=dev)
    mel = torch.as_tensor(_mel_matrix(cfg), device=dev)
    return partial(log_mel_features, cfg=cfg, dft_matrix=dft, mel_matrix=mel)
