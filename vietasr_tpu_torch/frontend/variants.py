"""Featurizer variants beyond log-mel (counterpart of
vietasr_tpu/frontend/variants.py): the linear power spectrogram and MFCCs
on the log-mel path's DFT matmul, the batch repeater and the
crop-or-pad of the time axis that speech-classification recipes use.

These run as plain PyTorch on the device of their input, as they run on
XLA in the JAX package (no Pallas kernel computes them there). Framing is
the log-mel path's: the whole (B, S) buffer pre-emphasized, reflect-padded
by n_fft // 2, 1 + S // hop frames. The JAX package's own choices are
kept as they are:
  - the spectrogram applies no dither, no splicing and no pad_to, and its
    log is always log(power + guard value);
  - MFCCs always take log(mel + guard value), whatever `cfg.log` and the
    guard type say;
  - crop_or_pad_spectrogram sets every row's length to `audio_length`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix, _normalize,
                                                 _windowed_dft_matrix,
                                                 feature_seq_len,
                                                 preemphasize_and_pad)
from vietasr_tpu_torch.utils.device import resolve_device


def _power_spectrum(signal: torch.Tensor, cfg: FeaturizerConfig,
                    dft_matrix: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (B, 1 + S // hop, n_fft // 2 + 1) fp32 |X|^2."""
    xp = preemphasize_and_pad(signal.to(torch.float32), cfg)
    frames = xp.unfold(1, cfg.fft_length, cfg.hop_length)
    spec = torch.matmul(frames, dft_matrix)
    n_bins = cfg.fft_length // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    return re * re + im * im


def _mask(x: torch.Tensor, seq_len: torch.Tensor, pad_value: float
          ) -> torch.Tensor:
    keep = (torch.arange(x.shape[1], device=x.device)[None, :, None]
            < seq_len[:, None, None])
    return torch.where(keep, x, torch.full_like(x, pad_value))


def spectrogram_features(signal: torch.Tensor, lengths: torch.Tensor, *,
                         cfg: FeaturizerConfig, dft_matrix: torch.Tensor):
    """(B, S) waveform + (B,) lengths -> (power (B, T, n_fft // 2 + 1),
    seq_len (B,) int32): log-compressed when cfg.log, normalized as
    cfg.normalize says, pad_value past each row's length."""
    seq_len = feature_seq_len(lengths, cfg.hop_length)
    power = _power_spectrum(signal, cfg, dft_matrix)
    if cfg.log:
        power = torch.log(power + cfg.log_zero_guard_value)
    if cfg.normalize:
        power = _normalize(power, seq_len, cfg.normalize)
    return _mask(power, seq_len, cfg.pad_value), seq_len


def _dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """(n_mfcc, n_mels) fp32 DCT-II with the orthonormal scaling."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels))
    m[0] *= 1.0 / np.sqrt(2)
    m *= np.sqrt(2.0 / n_mels)
    return m.astype(np.float32)


def mfcc_features(signal: torch.Tensor, lengths: torch.Tensor, *,
                  cfg: FeaturizerConfig, dft_matrix: torch.Tensor,
                  mel_matrix: torch.Tensor, dct: torch.Tensor):
    """MFCCs: power -> mel -> log(mel + guard value) -> DCT-II, normalized
    as cfg.normalize says. Output (B, T, n_mfcc), seq_len (B,)."""
    seq_len = feature_seq_len(lengths, cfg.hop_length)
    power = _power_spectrum(signal, cfg, dft_matrix)
    mel = torch.matmul(power, mel_matrix)
    logmel = torch.log(mel + cfg.log_zero_guard_value)
    mfcc = torch.matmul(logmel, dct.t())
    if cfg.normalize:
        mfcc = _normalize(mfcc, seq_len, cfg.normalize)
    return _mask(mfcc, seq_len, cfg.pad_value), seq_len


def make_spectrogram_featurizer(cfg: FeaturizerConfig, *, device=None):
    """Bind the DFT matrix on `device` (None: CUDA) and return
    featurize(signal, lengths)."""
    dft = torch.as_tensor(_windowed_dft_matrix(cfg),
                          device=resolve_device(device))
    return partial(spectrogram_features, cfg=cfg, dft_matrix=dft)


def make_mfcc_featurizer(cfg: FeaturizerConfig, n_mfcc: int = 64, *,
                         device=None):
    """Bind the DFT, mel and DCT matrices on `device` (None: CUDA) and
    return featurize(signal, lengths)."""
    dev = resolve_device(device)
    return partial(
        mfcc_features, cfg=cfg,
        dft_matrix=torch.as_tensor(_windowed_dft_matrix(cfg), device=dev),
        mel_matrix=torch.as_tensor(_mel_matrix(cfg), device=dev),
        dct=torch.as_tensor(_dct_matrix(n_mfcc, cfg.features), device=dev))


# ---------------------------------------------------------------------------


def multiply_batch(feats, feat_lens, tokens, token_lens, *, mult: int):
    """The batch repeated `mult` times along the batch axis."""
    rep = lambda x: torch.cat([x] * mult, dim=0)
    return rep(feats), rep(feat_lens), rep(tokens), rep(token_lens)


def crop_or_pad_spectrogram(feats: torch.Tensor, feat_lens: torch.Tensor, *,
                            audio_length: int, pad_value: float = 0.0):
    """(B, T, D) center-cropped, or padded with `pad_value` (the odd frame
    after), to `audio_length` frames; every row's length becomes
    `audio_length`."""
    t = feats.shape[1]
    if t > audio_length:
        start = (t - audio_length) // 2
        feats = feats[:, start:start + audio_length]
    elif t < audio_length:
        pad = audio_length - t
        feats = F.pad(feats, (0, 0, pad // 2, pad - pad // 2),
                      value=pad_value)
    return feats, torch.full_like(feat_lens, audio_length)
