"""Fused log-mel frontend: framing + windowed DFT + power + mel + log in one
CUDA kernel (csrc/frontend.cu), with a plain PyTorch version beside it.

Counterpart of vietasr_tpu/frontend/pallas_frontend.py::
fused_log_mel_features, with the same contract: (B, S) + lengths ->
(B, T padded to pad_to, n_mels), seq_len. The kernel replaces the Pallas
`_kernel`; it emits the log-mel frames and per-tile (sum, sum of squares)
partials over valid frames, and the Bessel-corrected per-feature
normalization stays a small plain epilogue, as it was an XLA epilogue in
JAX. Pre-emphasis and the reflect pad stay plain ops in front of it.

`fused_log_mel_features` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors; `fused_log_mel_features_plain` is
the plain version on any device (the reference the kernel is held to).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import torch

from vietasr_tpu_torch import _build
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix,
                                                 _windowed_dft_matrix,
                                                 feature_seq_len, log_guard,
                                                 mask_and_pad_time,
                                                 preemphasize_and_pad)
from vietasr_tpu_torch.utils.device import resolve_device
from vietasr_tpu_torch.utils.typing import assert_audio_batch

FRAMES_PER_TILE = 32          # FRAMES in csrc/frontend.cu
MAIN_BINS = 256               # NB_MAIN in csrc/frontend.cu
ROW_CHUNK = 16                # CHUNK in csrc/frontend.cu


def fused_supported(cfg: FeaturizerConfig) -> bool:
    """True when the fused kernel covers this config; the plain chain in
    features.py serves the rest (same numerics). Beyond the JAX package's
    conditions, the kernel's tiling needs 256 to 287 frequency bins
    (n_fft 512, as every shipped config has), hop a multiple of 4 and n_fft
    a multiple of 16."""
    return (cfg.frame_splicing == 1 and cfg.log
            and cfg.mag_power == 2.0
            and cfg.normalize in ("per_feature", "", None, False)
            and 0 <= cfg.fft_length // 2 + 1 - MAIN_BINS < 32
            and cfg.hop_length % 4 == 0 and cfg.fft_length % 16 == 0)


def log_mel_tiles_plain(xp: torch.Tensor, seq_len: torch.Tensor,
                        dft: torch.Tensor, mel: torch.Tensor, *,
                        cfg: FeaturizerConfig):
    """Plain version of the kernel: (B, S + n_fft) padded signal ->
    (logmel (B, t_out, n_mels), parts (B, n_tiles, 2, n_mels))."""
    n_fft, hop = cfg.fft_length, cfg.hop_length
    n_bins = n_fft // 2 + 1
    frames = xp.unfold(1, n_fft, hop)                       # (B, t_out, n_fft)
    spec = torch.matmul(frames, dft)
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    logmel = log_guard(torch.matmul(re * re + im * im, mel), cfg)
    bsz, t_out, n_mels = logmel.shape
    n_tiles = -(-t_out // FRAMES_PER_TILE)
    t_ids = torch.arange(n_tiles * FRAMES_PER_TILE, device=xp.device)
    valid = (t_ids[None, :] < seq_len[:, None])[:, :, None]
    tiled = torch.nn.functional.pad(
        logmel, (0, 0, 0, n_tiles * FRAMES_PER_TILE - t_out))
    tiled = torch.where(valid, tiled, torch.zeros_like(tiled)).reshape(
        bsz, n_tiles, FRAMES_PER_TILE, n_mels)
    parts = torch.stack([tiled.sum(2), (tiled * tiled).sum(2)], dim=2)
    return logmel, parts


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontend")
    if lib.vt_logmel_frames_per_tile() != FRAMES_PER_TILE \
            or lib.vt_logmel_row_chunk() != ROW_CHUNK:
        raise RuntimeError("csrc/frontend.cu FRAMES / CHUNK differ from "
                           "FRAMES_PER_TILE / ROW_CHUNK")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vt_logmel_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      i, i, i, ctypes.c_float, i, p]
    lib.vt_logmel_forward.restype = i
    lib.vt_logmel_smem_bytes.argtypes = [i, i, i, i]
    lib.vt_logmel_smem_bytes.restype = ctypes.c_longlong
    return lib


class PackedDFT(NamedTuple):
    """The kernel's layout of the (n_fft, 2 * n_bins) [re | im] DFT matrix
    (pack_dft): a constant of the config, packed once."""
    coef: torch.Tensor     # (n_fft, 512): [re | im] of bins 0..255
    extra: torch.Tensor    # (n_bins - 256, 2, n_fft): the other bins
    row_lo: int            # rows outside [row_lo, row_hi) are all zero
    row_hi: int


def pack_dft(dft: torch.Tensor, n_bins: int) -> PackedDFT:
    """coef rows are 16-byte aligned for cp.async and extra holds the
    remaining bins' columns as contiguous rows. [row_lo, row_hi) covers
    every row with a nonzero entry (the window's support), rounded out to
    whole ROW_CHUNKs: the kernel skips the rest, which add exact zeros."""
    m = MAIN_BINS
    coef = torch.cat([dft[:, :m], dft[:, n_bins:n_bins + m]], dim=1)
    extra = torch.stack([dft[:, m:n_bins].t(), dft[:, n_bins + m:].t()], 1)
    nonzero = torch.nonzero(dft.abs().amax(dim=1)).flatten().tolist()
    if nonzero:
        row_lo = nonzero[0] // ROW_CHUNK * ROW_CHUNK
        row_hi = -(-(nonzero[-1] + 1) // ROW_CHUNK) * ROW_CHUNK
    else:
        row_lo, row_hi = 0, ROW_CHUNK
    return PackedDFT(coef.contiguous(), extra.contiguous(), row_lo, row_hi)


def log_mel_tiles_cuda(xp: torch.Tensor, seq_len: torch.Tensor,
                       dft: PackedDFT, mel: torch.Tensor, *,
                       cfg: FeaturizerConfig):
    """The kernel: same contract as log_mel_tiles_plain, CUDA tensors only,
    with the DFT matrix in the kernel's layout (pack_dft)."""
    n_fft, hop = cfg.fft_length, cfg.hop_length
    n_bins = n_fft // 2 + 1
    n_mels = cfg.features
    bsz, sp = xp.shape
    if not isinstance(dft, PackedDFT):
        raise TypeError("frontend kernel: dft must be pack_dft's PackedDFT")
    for name, tsr, dtype in (("xp", xp, torch.float32),
                             ("seq_len", seq_len, torch.int32),
                             ("dft.coef", dft.coef, torch.float32),
                             ("dft.extra", dft.extra, torch.float32),
                             ("mel", mel, torch.float32)):
        if tsr.device.type != "cuda" or tsr.device != xp.device:
            raise ValueError(f"frontend kernel: {name} must be on "
                             f"{xp.device} (CUDA), got {tsr.device}")
        if tsr.dtype != dtype or not tsr.is_contiguous():
            raise ValueError(f"frontend kernel: {name} must be contiguous "
                             f"{dtype}, got {tsr.dtype}")
    if dft.coef.shape != (n_fft, 2 * MAIN_BINS) \
            or dft.extra.shape != (n_bins - MAIN_BINS, 2, n_fft) \
            or not 0 <= dft.row_lo < dft.row_hi <= n_fft \
            or mel.shape != (n_bins, n_mels) or seq_len.shape != (bsz,):
        raise ValueError("frontend kernel: dft/mel/seq_len shapes do not "
                         "match the config")
    if not fused_supported(cfg):
        raise ValueError("frontend kernel: config not covered "
                         "(see fused_supported)")
    lib = _lib()
    smem = lib.vt_logmel_smem_bytes(n_fft, hop, n_bins, n_mels)
    if not 0 < smem <= _build.SMEM_LIMIT:
        raise ValueError(f"frontend kernel: n_fft={n_fft}, hop={hop}, "
                         f"n_mels={n_mels} are outside the kernel's plan")
    t_out = (sp - n_fft) // hop + 1
    n_tiles = -(-t_out // FRAMES_PER_TILE)
    logmel = torch.empty((bsz, t_out, n_mels), dtype=torch.float32,
                         device=xp.device)
    parts = torch.empty((bsz, n_tiles, 2, n_mels), dtype=torch.float32,
                        device=xp.device)
    with torch.cuda.device(xp.device):
        err = lib.vt_logmel_forward(
            xp.data_ptr(), seq_len.data_ptr(), dft.coef.data_ptr(),
            dft.extra.data_ptr(), mel.data_ptr(), logmel.data_ptr(),
            parts.data_ptr(), bsz, sp,
            t_out, n_fft, hop, n_bins, n_mels, dft.row_lo, dft.row_hi,
            float(cfg.log_zero_guard_value),
            int(cfg.log_zero_guard_type == "clamp"),
            torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(lib, err, "frontend kernel")
    fused_log_mel_features.launches += 1
    return logmel, parts


def _featurize(signal, lengths, cfg: FeaturizerConfig, tiles_fn,
               dft_matrix, mel_matrix):
    assert_audio_batch(signal, lengths, port="featurizer.input_signal")
    if not fused_supported(cfg):
        raise NotImplementedError(
            "fused frontend: config not covered (see fused_supported)")
    xp = preemphasize_and_pad(signal.to(torch.float32), cfg).contiguous()
    seq_len = feature_seq_len(lengths, cfg.hop_length)
    if dft_matrix is None:
        dft_matrix = torch.as_tensor(_windowed_dft_matrix(cfg),
                                     device=xp.device)
    if tiles_fn is log_mel_tiles_cuda and not isinstance(dft_matrix,
                                                         PackedDFT):
        dft_matrix = pack_dft(dft_matrix, cfg.fft_length // 2 + 1)
    if mel_matrix is None:
        mel_matrix = torch.as_tensor(_mel_matrix(cfg), device=xp.device)
    logmel, parts = tiles_fn(xp, seq_len, dft_matrix, mel_matrix, cfg=cfg)

    # plain epilogue: Bessel-corrected per-feature normalization from the
    # per-tile partials (single pass, as the Pallas wrapper does)
    n = torch.clamp_min(seq_len, 1).to(torch.float32)[:, None]   # (B, 1)
    s1 = parts[:, :, 0].sum(1)
    s2 = parts[:, :, 1].sum(1)
    mean = s1 / n
    var = torch.clamp_min(s2 - n * mean * mean, 0.0) \
        / torch.clamp_min(n - 1.0, 1.0)
    feats = logmel
    if cfg.normalize == "per_feature":
        feats = (feats - mean[:, None, :]) \
            / (torch.sqrt(var)[:, None, :] + 1e-5)
    return mask_and_pad_time(feats, seq_len, logmel.shape[1], cfg), seq_len


def fused_log_mel_features(signal: torch.Tensor, lengths: torch.Tensor, *,
                           cfg: FeaturizerConfig,
                           dft_matrix: Union[torch.Tensor, PackedDFT,
                                             None] = None,
                           mel_matrix: Optional[torch.Tensor] = None):
    """(B, S) float waveform + (B,) int lengths ->
    (feats (B, T_padded, n_mels) fp32, seq_len (B,) int32).

    CUDA tensors go through the kernel (counted in `.launches`); CPU
    tensors through its plain version. The constant DFT / mel matrices are
    built on the signal's device, and the DFT packed for the kernel, unless
    given (make_fused_featurizer builds and packs them once)."""
    tiles = log_mel_tiles_plain if signal.device.type == "cpu" \
        else log_mel_tiles_cuda
    return _featurize(signal, lengths, cfg, tiles, dft_matrix, mel_matrix)


fused_log_mel_features.launches = 0


def fused_log_mel_features_plain(signal: torch.Tensor, lengths: torch.Tensor,
                                 *, cfg: FeaturizerConfig,
                                 dft_matrix: Optional[torch.Tensor] = None,
                                 mel_matrix: Optional[torch.Tensor] = None):
    """The plain version of fused_log_mel_features, on any device."""
    return _featurize(signal, lengths, cfg, log_mel_tiles_plain, dft_matrix,
                      mel_matrix)


def make_fused_featurizer(cfg: FeaturizerConfig, *, device=None):
    """Same factory contract as features.make_featurizer. On the GPU the
    DFT matrix is bound in the kernel's layout, packed once here."""
    dev = resolve_device(device)
    dft = torch.as_tensor(_windowed_dft_matrix(cfg), device=dev)
    if dev.type == "cuda":
        dft = pack_dft(dft, cfg.fft_length // 2 + 1)
    return functools.partial(
        fused_log_mel_features, cfg=cfg, dft_matrix=dft,
        mel_matrix=torch.as_tensor(_mel_matrix(cfg), device=dev))
