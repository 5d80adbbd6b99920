"""Fused log-mel frontend: framing + window + DFT + power + mel + log in one
CUDA kernel, with a plain PyTorch version beside it, in two precisions.

Counterpart of vietasr_tpu/frontend/pallas_frontend.py::
fused_log_mel_features, with the same contract:
(B, S) + lengths -> (B, T padded to pad_to, n_mels), seq_len. The kernel
replaces the Pallas `_kernel`; it emits the log-mel frames and per-tile
(sum, M2) partials over valid frames, M2 being the sum of squares about
the tile's own mean, and the Bessel-corrected per-feature normalization
stays a small plain epilogue that merges the tiles by Chan et al.'s
parallel formula, as it was an XLA epilogue in JAX. Pre-emphasis and the
reflect pad stay plain ops in front of it.

precision="highest" (the default): csrc/frontend.cu computes the
one-sided spectrum by an FFT (fp64 inside, fp32 in and out) from the
constants of `fft_tables`; its plain version, `log_mel_tiles_plain`, is
the TPU kernel's function as written there: frames @ windowed-DFT matrix
in fp32.

precision="default" (the pipeline's fused_frontend="fast"):
csrc/frontend_fast.cu runs frames @ DFT and power @ mel on the tensor
cores with the TPU kernel's single-pass bf16 rounding points (signal, DFT
matrix, power and mel matrix rounded to bf16, fp32 accumulation) from
the constants of `fast_tables`; its plain version is
`log_mel_tiles_fast_plain`. This is the default-precision accuracy
class: O(1) log-mel error on spectral-floor bins.

`fused_log_mel_features` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors; `fused_log_mel_features_plain`
is the plain version on any device (the reference the kernel is held
to). The same route, for both precisions, is the custom op
`vietasr::log_mel_tiles` (ops/custom_ops.py), which the wrapper calls
while an export traces.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from vietasr_tpu_torch import _build
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix, _window_full,
                                                 _windowed_dft_matrix,
                                                 add_dither, feature_seq_len,
                                                 log_guard,
                                                 mask_and_pad_time,
                                                 preemphasize_and_pad)
from vietasr_tpu_torch.ops import custom_ops
from vietasr_tpu_torch.utils.device import resolve_device
from vietasr_tpu_torch.utils.typing import assert_audio_batch

FRAMES_PER_TILE = 16          # FRAMES in csrc/frontend.cu
FFT_LENGTH = 512              # NFFT: the FFT is 16 x 16 complex points
MEL_RUNS = 16                 # RUNS: mel tap runs, one per half-warp
TWIDDLE_ROWS = 16 * 16 + 8 * 16   # TW_ROWS: W256^(l k1), W512^(l + 16 k2)
TAP_BASE = 20                 # TAP_BASE: mel_index's run starts, padded
MAX_MELS = 128                # MAX_MELS
FAST_BINS = 272               # BINS in csrc/frontend_fast.cu: 257 padded
FAST_MAX_ROWS = 320           # KROWS: DFT rows the kernel holds
FAST_CHUNK_COLS = 32          # CHUNK_COLS: DFT columns a ring stage holds
FAST_MAX_STAGES = 8           # MAX_STAGES
FAST_WG_FRAMES = 64           # WG_FRAMES: frames a consumer warpgroup takes
FAST_MEL_KSTEPS = FAST_BINS // 16   # MEL_KSTEPS: k16 steps of power @ mel
# MAX_MEL_BLOCKS: the filterbank's bands' 256-byte blocks ride one ring stage
FAST_MAX_MEL_BLOCKS = FAST_CHUNK_COLS * FAST_MAX_ROWS * 2 // 256
_FAST_BAR_BYTES = 256         # BAR_BYTES: the ring's and samples' mbarriers
_FAST_POWER_PITCH = FAST_BINS + 8   # PP: the power tile's row pitch (bf16)
PRECISIONS = ("highest", "default")


def fused_supported(cfg: FeaturizerConfig) -> bool:
    """True when the fused kernel covers this config; the plain chain in
    features.py serves the rest (same numerics). Beyond the JAX package's
    conditions, the kernel's FFT needs n_fft 512 (as every shipped config
    has), a hop of at most n_fft and at most 128 mels."""
    return (cfg.frame_splicing == 1 and cfg.log
            and cfg.mag_power == 2.0
            and cfg.normalize in ("per_feature", "", None, False)
            and cfg.fft_length == FFT_LENGTH
            and 1 <= cfg.hop_length <= FFT_LENGTH
            and 1 <= cfg.features <= MAX_MELS)


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
    return logmel, tile_partials(logmel, seq_len)


def tile_partials(logmel: torch.Tensor, seq_len: torch.Tensor
                  ) -> torch.Tensor:
    """(B, t_out, n_mels) log-mel -> (B, n_tiles, 2, n_mels): each
    FRAMES_PER_TILE-frame tile's (sum, M2) over the frames inside seq_len,
    M2 the sum of squares about the tile's own mean (0 for a tile with no
    such frame), in fp64 rounded once to fp32: the deviations d = v - v0
    from the tile's first frame, their sum and squares, the sum c v0 +
    sum d and M2 = sum d^2 - (sum d)^2 / c. Both kernels compute the same
    in one fp32 pass, within fp32 rounding of sum d^2 <= c M2 (no frame
    lies further than sqrt(c - 1) standard deviations from its tile's
    mean). Fp32 sums of v and v^2 (the JAX Pallas kernel's partials)
    would leave the epilogue to cancel sum v^2 - n mean^2 instead."""
    bsz, t_out, n_mels = logmel.shape
    n_tiles = -(-t_out // FRAMES_PER_TILE)
    t_ids = torch.arange(n_tiles * FRAMES_PER_TILE, device=logmel.device)
    valid = (t_ids[None, :] < seq_len[:, None]).reshape(
        bsz, n_tiles, FRAMES_PER_TILE, 1)
    tiled = torch.nn.functional.pad(
        logmel, (0, 0, 0, n_tiles * FRAMES_PER_TILE - t_out)).reshape(
            bsz, n_tiles, FRAMES_PER_TILE, n_mels).double()
    counts = tile_counts(seq_len, n_tiles).double()[:, :, None]
    first = tiled[:, :, 0]
    dev = torch.where(valid, tiled - first[:, :, None], 0.0)
    dsum = dev.sum(2)
    total = torch.where(counts > 0, counts * first + dsum, 0.0)
    m2 = (dev * dev).sum(2) - dsum * dsum / counts.clamp_min(1.0)
    return torch.stack([total, m2.clamp_min(0.0)], dim=2).to(logmel.dtype)


def tile_counts(seq_len: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """(B,) seq_len -> (B, n_tiles) fp32: the frames inside seq_len of
    each FRAMES_PER_TILE-frame tile, clamp(seq_len - 16 i, 0, 16)."""
    start = torch.arange(n_tiles, device=seq_len.device) * FRAMES_PER_TILE
    return torch.clamp(seq_len[:, None] - start[None, :], 0,
                       FRAMES_PER_TILE).to(torch.float32)


def merge_tile_stats(parts: torch.Tensor, seq_len: torch.Tensor):
    """(B, n_tiles, 2, n_mels) (sum, M2) partials -> (shift, offset, var),
    each (B, n_mels) fp32, the mean being shift + offset: the tiles merged
    by Chan et al.'s parallel formula, M2 = sum M2_i + sum c_i (m_i -
    mean)^2 with c_i the tile's frames inside seq_len and m_i = s_i /
    max(c_i, 1), over n = max(seq_len, 1) frames (the Pallas wrapper's n),
    var = M2 / max(n - 1, 1). Two-pass in effect, so a nearly constant bin
    keeps its variance where the one-pass (sum x^2 - n mean^2) / (n - 1)
    cancels to noise.

    All in fp32, about a shift: tile 0's mean rounded to bf16, so that c_i
    * shift is exact and s_i - c_i * shift loses nothing. A plain fp32 sum
    of a clip's tile sums near -16.6 * 16 would move the mean by ~1e-5,
    which a bin of std ~1e-3 turns into 1e-2 of a feature; the offset
    keeps the mean's low bits for the features' subtraction."""
    counts = tile_counts(seq_len, parts.shape[1])[:, :, None]
    n = torch.clamp_min(seq_len, 1).to(torch.float32)[:, None]   # (B, 1)
    s = parts[:, :, 0]
    shift = _bf16(s[:, 0] / counts[:, 0].clamp_min(1.0))
    e = s - counts * shift[:, None, :]          # c_i (m_i - shift)
    offset = e.sum(1) / n
    dm = e / counts.clamp_min(1.0) - offset[:, None, :]
    m2 = parts[:, :, 1].sum(1) + (counts * dm * dm).sum(1)
    return shift, offset, m2 / torch.clamp_min(n - 1.0, 1.0)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """a rounded to bf16 (to nearest, ties to even), back in fp32."""
    return a.to(torch.bfloat16).to(torch.float32)


def fast_mel_power_plain(xp: torch.Tensor, dft: torch.Tensor,
                         mel: torch.Tensor, *, cfg: FeaturizerConfig
                         ) -> torch.Tensor:
    """(B, S + n_fft) padded fp32 signal -> (B, t_out, n_mels) mel power
    at the TPU kernel's precision="default" rounding points: the signal,
    the fp32 windowed-DFT matrix, the power and the fp32 mel matrix each
    rounded to bf16 once; the products (exact in fp32) summed in fp32."""
    n_fft, hop = cfg.fft_length, cfg.hop_length
    n_bins = n_fft // 2 + 1
    frames = _bf16(xp).unfold(1, n_fft, hop)
    spec = torch.matmul(frames, _bf16(dft))
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    return torch.matmul(_bf16(re * re + im * im), _bf16(mel))


def log_mel_tiles_fast_plain(xp: torch.Tensor, seq_len: torch.Tensor,
                             dft: torch.Tensor, mel: torch.Tensor, *,
                             cfg: FeaturizerConfig):
    """Plain version of the bf16 kernel (csrc/frontend_fast.cu), with
    log_mel_tiles_plain's arguments and outputs: the fp32 DFT and mel
    matrices, (logmel, parts)."""
    logmel = log_guard(fast_mel_power_plain(xp, dft, mel, cfg=cfg), cfg)
    return logmel, tile_partials(logmel, seq_len)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontend")
    got = (lib.vt_logmel_frames_per_tile(), lib.vt_logmel_fft_length(),
           lib.vt_logmel_mel_runs(), lib.vt_logmel_twiddle_rows(),
           lib.vt_logmel_tap_base())
    if got != (FRAMES_PER_TILE, FFT_LENGTH, MEL_RUNS, TWIDDLE_ROWS,
               TAP_BASE):
        raise RuntimeError(
            f"csrc/frontend.cu FRAMES / NFFT / RUNS / TW_ROWS / TAP_BASE "
            f"{got} differ from cuda_frontend.py's FRAMES_PER_TILE / "
            "FFT_LENGTH / MEL_RUNS / TWIDDLE_ROWS / TAP_BASE")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vt_logmel_forward.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                      i, i, i, i, ctypes.c_float, i, p]
    lib.vt_logmel_forward.restype = i
    lib.vt_logmel_smem_bytes.argtypes = [i, i, i, i]
    lib.vt_logmel_smem_bytes.restype = ctypes.c_longlong
    return lib


class FFTTables(NamedTuple):
    """The kernel's constants for one config (fft_tables), built once."""
    window: torch.Tensor      # (n_fft,) fp32: the zero-padded window
    twiddle: torch.Tensor     # (TWIDDLE_ROWS, 2) fp64 (cos, sin) rows
    mel_index: torch.Tensor   # int32: run starts (to TAP_BASE), taps
    mel_weight: torch.Tensor  # fp32: the packed taps' weights
    taps: int                 # packed taps (a multiple of 4)
    win_lo: int               # the window is zero outside [win_lo, win_hi)
    win_hi: int


def twiddle_table() -> np.ndarray:
    """(TWIDDLE_ROWS, 2) fp64 (cos, sin) of the kernel's twiddles W =
    exp(-2 pi i e / N) = cos - i sin: row k1 * 16 + l holds W256^(l k1)
    (stage 1 of the 16 x 16 FFT), row 256 + k2 * 16 + l holds W512^(l +
    16 k2) (the real split of bin l + 16 k2). Exponents are reduced in
    integers, so each entry is one fp64 cos / sin of an angle in [0, 2 pi)."""
    lane = np.arange(16)
    e1 = (lane[None, :] * np.arange(16)[:, None]) % 256        # [k1][l]
    e2 = lane[None, :] + 16 * np.arange(8)[:, None]            # [k2][l]
    ang = np.concatenate([2.0 * np.pi * e1.ravel() / 256,
                          2.0 * np.pi * e2.ravel() / 512])
    return np.stack([np.cos(ang), np.sin(ang)], axis=1)


def pack_mel_taps(mel: np.ndarray, runs: int = MEL_RUNS):
    """(n_bins, n_mels) filterbank -> (index int32, weight fp32, taps).
    Each filter's nonzero taps, in bin order, filters in order; a filter
    with none gets one tap of weight 0. The filters are cut into `runs`
    contiguous runs whose largest tap count is as small as it can be (one
    run a half-warp in the kernel), each run padded to a multiple of 4 taps
    with weight-0 taps (the kernel loads 4 at a time). index = [run starts
    (runs + 1), zero-padded to a multiple of 4 | per tap: bin | last of
    its filter << 10 | filter << 11]; weight: per tap."""
    n_bins, n_mels = mel.shape
    if n_bins > 1 << 10:
        raise ValueError("pack_mel_taps: more than 1024 bins")
    per_mel = []
    for m in range(n_mels):
        nz = np.flatnonzero(mel[:, m])
        per_mel.append(nz if nz.size else np.zeros(1, np.int64))
    counts = [len(b) for b in per_mel]
    lo, hi = max(counts), sum(counts)
    while lo < hi:                      # least feasible run capacity
        cap = (lo + hi) // 2
        n_runs, fill = 1, 0
        for c in counts:
            if fill + c > cap:
                n_runs, fill = n_runs + 1, 0
            fill += c
        lo, hi = (cap + 1, hi) if n_runs > runs else (lo, cap)
    groups, fill = [[]], 0
    for m, c in enumerate(counts):
        if fill + c > lo:
            groups.append([])
            fill = 0
        groups[-1].append(m)
        fill += c
    starts, code, weight = [0], [], []
    for run in groups:
        for m in run:
            bins = per_mel[m]
            last = np.zeros(len(bins), np.int64)
            last[-1] = 1
            code.append(bins | (last << 10) | (m << 11))
            weight.append(mel[bins, m])
        pad = -sum(counts[m] for m in run) % 4
        code.append(np.full(pad, run[-1] << 11, np.int64))
        weight.append(np.zeros(pad, np.float32))
        starts.append(starts[-1] + sum(counts[m] for m in run) + pad)
    starts += [starts[-1]] * (runs + 1 - len(starts))
    starts += [0] * (-len(starts) % 4)
    index = np.concatenate([np.asarray(starts, np.int64)] + code)
    return (index.astype(np.int32),
            np.concatenate(weight).astype(np.float32), starts[runs])


def fft_tables(cfg: FeaturizerConfig, device=None) -> FFTTables:
    """The kernel's constants for cfg, on `device`: the window taps
    (_window_full rounded once to fp32, i.e. column 0 of the windowed DFT
    matrix), the twiddle table and the packed mel taps."""
    win64 = _window_full(cfg)
    nz = np.flatnonzero(win64.astype(np.float32))
    index, weight, taps = pack_mel_taps(_mel_matrix(cfg))
    dev = torch.device("cpu") if device is None else torch.device(device)
    return FFTTables(
        window=torch.as_tensor(win64.astype(np.float32), device=dev),
        twiddle=torch.as_tensor(twiddle_table(), device=dev),
        mel_index=torch.as_tensor(index, device=dev),
        mel_weight=torch.as_tensor(weight, device=dev), taps=taps,
        win_lo=int(nz[0]), win_hi=int(nz[-1]) + 1)


def log_mel_tiles_cuda(xp: torch.Tensor, seq_len: torch.Tensor,
                       tables: FFTTables, *, cfg: FeaturizerConfig):
    """The kernel: same contract as log_mel_tiles_plain, CUDA tensors only,
    with the config's constants from fft_tables."""
    n_fft, hop, n_mels = cfg.fft_length, cfg.hop_length, cfg.features
    if not isinstance(tables, FFTTables):
        raise TypeError("frontend kernel: tables must be fft_tables' "
                        "FFTTables")
    if not fused_supported(cfg):
        raise ValueError("frontend kernel: config not covered "
                         "(see fused_supported)")
    bsz, sp = xp.shape
    for name, tsr, dtype in (("xp", xp, torch.float32),
                             ("seq_len", seq_len, torch.int32),
                             ("window", tables.window, torch.float32),
                             ("twiddle", tables.twiddle, torch.float64),
                             ("mel_index", tables.mel_index, torch.int32),
                             ("mel_weight", tables.mel_weight,
                              torch.float32)):
        if tsr.device.type != "cuda" or tsr.device != xp.device:
            raise ValueError(f"frontend kernel: {name} must be on "
                             f"{xp.device} (CUDA), got {tsr.device}")
        if tsr.dtype != dtype or not tsr.is_contiguous():
            raise ValueError(f"frontend kernel: {name} must be contiguous "
                             f"{dtype}, got {tsr.dtype}")
    taps = tables.taps
    if tables.window.shape != (n_fft,) \
            or tables.twiddle.shape != (TWIDDLE_ROWS, 2) \
            or tables.mel_index.numel() != TAP_BASE + taps \
            or tables.mel_weight.numel() != taps or taps % 4 \
            or not 0 <= tables.win_lo < tables.win_hi <= n_fft \
            or seq_len.shape != (bsz,) or sp < n_fft:
        raise ValueError("frontend kernel: tables / seq_len / xp shapes do "
                         "not match the config")
    if any(t.data_ptr() % 16 for t in (xp, tables.mel_index,
                                       tables.mel_weight)):
        raise ValueError("frontend kernel: xp and the mel taps must be "
                         "16-byte aligned")
    lib = _lib()
    smem = lib.vt_logmel_smem_bytes(n_fft, hop, n_mels, taps)
    if not 0 < smem <= _build.SMEM_LIMIT:
        raise ValueError(f"frontend kernel: n_fft={n_fft}, hop={hop}, "
                         f"n_mels={n_mels}, {taps} mel taps are outside "
                         "the kernel's plan")
    t_out = (sp - n_fft) // hop + 1
    n_tiles = -(-t_out // FRAMES_PER_TILE)
    logmel = torch.empty((bsz, t_out, n_mels), dtype=torch.float32,
                         device=xp.device)
    parts = torch.empty((bsz, n_tiles, 2, n_mels), dtype=torch.float32,
                        device=xp.device)
    with torch.cuda.device(xp.device):
        err = lib.vt_logmel_forward(
            xp.data_ptr(), seq_len.data_ptr(), tables.window.data_ptr(),
            tables.twiddle.data_ptr(), tables.mel_index.data_ptr(),
            tables.mel_weight.data_ptr(), logmel.data_ptr(),
            parts.data_ptr(), bsz, sp, t_out, n_fft, hop, n_mels, taps,
            tables.win_lo, tables.win_hi, float(cfg.log_zero_guard_value),
            int(cfg.log_zero_guard_type == "clamp"),
            torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(lib, err, "frontend kernel")
    fused_log_mel_features.launches += 1
    return logmel, parts


class FastTables(NamedTuple):
    """The bf16 kernel's constants for one config (fast_tables)."""
    dft: torch.Tensor    # (2 * FAST_BINS * k_rows,) bf16: fast_dft_offset
    mel: torch.Tensor    # (128 * blocks,) bf16: the filterbank's bands'
    #                      blocks, fast_mel_offset
    mel_bands: tuple     # per 8-mel tile (first k16 step, steps)
    k_lo: int            # the first DFT row held (a multiple of 8)
    k_rows: int          # rows held (a multiple of 16)


def fast_rows(cfg: FeaturizerConfig):
    """(k_lo, k_rows): the DFT rows the bf16 kernel multiplies, from a
    multiple-of-8 start: the window's nonzero samples widened to the
    FAST_MAX_ROWS rows the kernel always holds (rows 96..415 for the 20 ms
    Hann window in 512), kept inside the frame, or, for a window longer
    than that, its nonzero rows widened to a multiple of 16 (more than the
    kernel takes). The other rows of the windowed DFT matrix are zero."""
    n_fft = cfg.fft_length
    nz = np.flatnonzero(_window_full(cfg).astype(np.float32))
    k_lo = int(nz[0]) // 8 * 8
    k_rows = max(FAST_MAX_ROWS, -(-(int(nz[-1]) + 1 - k_lo) // 16) * 16)
    return min(k_lo, (n_fft - k_rows) // 8 * 8), k_rows


def fast_dft_offset(col, k, k_rows: int):
    """Offset in fast_tables' `dft` of the DFT operand's entry (column col,
    held row k), elementwise over numpy arrays. Column 2 b is the real part
    of bin b, 2 b + 1 its imaginary part; row k is DFT row k_lo + k. The
    table is the kernel's ring stages one after another, as each is copied
    whole: chunk col // FAST_CHUNK_COLS, then within it the wgmma B operand
    K-major without swizzle, core matrices of 8 columns x 8 rows (8 x 16
    bytes, a column's 8 rows contiguous) with the column groups of one
    8-row slice of k side by side."""
    col, k = np.asarray(col), np.asarray(k)
    chunk, n = col // FAST_CHUNK_COLS, col % FAST_CHUNK_COLS
    core = (k // 8) * (FAST_CHUNK_COLS // 8) + n // 8
    return chunk * FAST_CHUNK_COLS * k_rows + core * 64 + (n % 8) * 8 + k % 8


def fast_mel_bands(mel_t: np.ndarray) -> tuple:
    """(ceil(n_mels / 8) * 8, FAST_BINS) transposed filterbank -> per 8-mel
    tile, the band (first k16 step, steps) of the 16-bin steps from its
    first to its last that hold a nonzero of it: the blocks the kernel
    multiplies ((0, 0) for a tile of zeros). A banded filterbank leaves
    most blocks out (24 of 136 at 64 mels)."""
    tiles = mel_t.shape[0] // 8
    nz = (mel_t.reshape(tiles, 8, FAST_MEL_KSTEPS, 16) != 0).any((1, 3))
    bands = []
    for t in range(tiles):
        steps = np.flatnonzero(nz[t])
        bands.append((int(steps[0]), int(steps[-1] - steps[0] + 1))
                     if steps.size else (0, 0))
    return tuple(bands)


def fast_mel_offset(m, k, bands):
    """Offset in fast_tables' `mel` of the filterbank's entry (mel m, bin
    k), elementwise over numpy arrays; -1 outside its 8-mel tile's band
    (all zeros). The bands' 16-bin x 8-mel blocks lie by tile and then
    16-bin step, 256 bytes each: mma.sync m16n8k16's B fragments as the
    kernel loads them, lane n * 4 + (k % 8) // 2 holding bins k % 16 and
    k % 16 + 1 of mel n in its first 4 bytes for k % 16 < 8, in its second
    4 bytes for the bins 8 further on."""
    m, k = np.asarray(m), np.asarray(k)
    lo = np.array([b[0] for b in bands])
    n = np.array([b[1] for b in bands])
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    t, step = m // 8, k // 16
    inside = (step >= lo[t]) & (step < lo[t] + n[t])
    block = first[t] + step - lo[t]
    kk = k % 16
    lane = (m % 8) * 4 + (kk % 8) // 2
    off = ((block * 32 + lane) * 2 + kk // 8) * 2 + kk % 2
    return np.where(inside, off, -1)


def fast_tables(cfg: FeaturizerConfig, device=None) -> FastTables:
    """The bf16 kernel's constants for cfg, on `device`: the fp32 windowed
    DFT matrix's rows fast_rows(cfg), re and im of each bin in adjacent
    columns, bins zero-padded to FAST_BINS, rounded to bf16 and laid out by
    fast_dft_offset; the fp32 mel matrix zero-padded to whole 8-mel tiles
    and FAST_BINS bins, rounded to bf16, the blocks of its bands
    (fast_mel_bands) laid out by fast_mel_offset.
    These are the values the plain version rounds the same matrices to."""
    n_fft = cfg.fft_length
    n_bins = n_fft // 2 + 1
    k_lo, k_rows = fast_rows(cfg)
    dft = _windowed_dft_matrix(cfg)[k_lo:k_lo + k_rows]    # (k_rows, 2 nb)
    op = np.zeros((k_rows, FAST_BINS, 2), np.float32)
    op[:, :n_bins, 0] = dft[:, :n_bins]
    op[:, :n_bins, 1] = dft[:, n_bins:]
    cols, ks = np.meshgrid(np.arange(2 * FAST_BINS), np.arange(k_rows),
                           indexing="ij")
    dft_flat = np.zeros(2 * FAST_BINS * k_rows, np.float32)
    dft_flat[fast_dft_offset(cols, ks, k_rows)] = op.reshape(
        k_rows, 2 * FAST_BINS).T
    mel8 = -(-cfg.features // 8) * 8
    mel_t = np.zeros((mel8, FAST_BINS), np.float32)
    mel_t[:cfg.features, :n_bins] = _mel_matrix(cfg).T
    bands = fast_mel_bands(mel_t)
    ms, bins = np.meshgrid(np.arange(mel8), np.arange(FAST_BINS),
                           indexing="ij")
    off = fast_mel_offset(ms, bins, bands)
    mel_flat = np.zeros(128 * sum(n for _, n in bands), np.float32)
    mel_flat[off[off >= 0]] = mel_t[off >= 0]
    dev = torch.device("cpu") if device is None else torch.device(device)

    def bf16(a):
        return torch.as_tensor(a, device=dev).to(torch.bfloat16)

    return FastTables(dft=bf16(dft_flat), mel=bf16(mel_flat),
                      mel_bands=bands, k_lo=k_lo, k_rows=k_rows)


class FastPlan(NamedTuple):
    """One launch of the bf16 kernel: blocks of `frames` frames (one
    consumer warpgroup per 64), a ring of `stages` DFT chunks of
    `chunk_cols` columns, `smem` bytes of dynamic shared memory."""
    frames: int
    chunk_cols: int
    stages: int
    smem: int


def fast_plan_smem(hop: int, frames: int, stages: int) -> int:
    """Shared memory of a launch (csrc/frontend_fast.cu::layout): the
    mbarriers, `stages` chunks of FAST_CHUNK_COLS x FAST_MAX_ROWS bf16, a
    tile's (frames - 1) * hop + FAST_MAX_ROWS bf16 samples with 8 bf16 of
    pad after every hop of them when hop / 8 is even, and the bf16 power
    tile of frames x (FAST_BINS + 8)."""
    span = (frames - 1) * hop + FAST_MAX_ROWS
    pad = 8 if (hop // 8) % 2 == 0 else 0
    return (_FAST_BAR_BYTES + stages * FAST_CHUNK_COLS * FAST_MAX_ROWS * 2
            + 2 * (span + (span - 1) // hop * pad)
            + frames * _FAST_POWER_PITCH * 2)


def fast_shape_plan(n_fft: int, hop: int, n_mels: int, k_rows: int
                    ) -> Optional[FastPlan]:
    """The launch plan for one shape, or None outside the kernel's reach
    (n_fft 512, a hop from 8 to 512 that is a multiple of 8, 1 to 128 mels,
    k_rows, the DFT rows the window needs, a multiple of 16 from 16 to
    FAST_MAX_ROWS; the kernel holds FAST_MAX_ROWS, zero past the window's):
    128 frames a block (two consumer warpgroups share each DFT chunk) while
    a ring of at least 3 stages fits beside the tile's samples, else 64
    frames with at least 2; the deepest ring up to FAST_MAX_STAGES that
    fits an H100 block's shared memory."""
    if not (n_fft == FFT_LENGTH and 8 <= hop <= FFT_LENGTH and hop % 8 == 0
            and 1 <= n_mels <= MAX_MELS and 16 <= k_rows <= FAST_MAX_ROWS
            and k_rows % 16 == 0):
        return None
    stage = FAST_CHUNK_COLS * FAST_MAX_ROWS * 2
    for frames, least in ((2 * FAST_WG_FRAMES, 3), (FAST_WG_FRAMES, 2)):
        room = _build.SMEM_LIMIT - fast_plan_smem(hop, frames, 0)
        stages = min(FAST_MAX_STAGES, room // stage)
        if stages >= least:
            return FastPlan(frames, FAST_CHUNK_COLS, stages,
                            fast_plan_smem(hop, frames, stages))
    return None


def fast_plan(cfg: FeaturizerConfig) -> Optional[FastPlan]:
    """fast_shape_plan for cfg's DFT rows (fast_rows), or None."""
    return fast_shape_plan(cfg.fft_length, cfg.hop_length, cfg.features,
                           fast_rows(cfg)[1])


@functools.lru_cache(maxsize=1)
def _fast_lib() -> ctypes.CDLL:
    lib = _build.load("frontend_fast")
    got = (lib.vt_logmel_fast_frames_per_tile(), lib.vt_logmel_fast_bins(),
           lib.vt_logmel_fast_max_rows(), lib.vt_logmel_fast_chunk_cols(),
           lib.vt_logmel_fast_max_stages())
    if got != (FRAMES_PER_TILE, FAST_BINS, FAST_MAX_ROWS, FAST_CHUNK_COLS,
               FAST_MAX_STAGES):
        raise RuntimeError(
            f"csrc/frontend_fast.cu PART / BINS / 16 * MAX_KSTEPS / "
            f"CHUNK_COLS / MAX_STAGES {got} differ from cuda_frontend.py's "
            "FRAMES_PER_TILE / FAST_BINS / FAST_MAX_ROWS / FAST_CHUNK_COLS / "
            "FAST_MAX_STAGES")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.vt_logmel_fast_forward.argtypes = [
        p, p, p, p, ctypes.POINTER(i), i, p, p, i, i, i, i, i, i, i, i, i, i,
        i, ll, ctypes.c_float, i, ctypes.POINTER(i), p]
    lib.vt_logmel_fast_forward.restype = i
    lib.vt_logmel_fast_plan_smem.argtypes = [i] * 6
    lib.vt_logmel_fast_plan_smem.restype = ll
    return lib


def log_mel_tiles_fast_cuda(xp: torch.Tensor, seq_len: torch.Tensor,
                            tables: FastTables, *, cfg: FeaturizerConfig,
                            plan: Optional[FastPlan] = None):
    """The bf16 kernel: same contract as log_mel_tiles_fast_plain, CUDA
    tensors only, with the config's constants from fast_tables, launched
    by `plan` (default fast_plan(cfg)). Counts its launches in
    `.launches`; `.last_blocks` is the last launch's grid."""
    n_fft, hop, n_mels = cfg.fft_length, cfg.hop_length, cfg.features
    if not isinstance(tables, FastTables):
        raise TypeError("bf16 frontend kernel: tables must be fast_tables' "
                        "FastTables")
    if not fused_supported(cfg):
        raise ValueError("bf16 frontend kernel: config not covered "
                         "(see fused_supported)")
    bsz, sp = xp.shape
    for name, tsr, dtype in (("xp", xp, torch.float32),
                             ("seq_len", seq_len, torch.int32),
                             ("dft", tables.dft, torch.bfloat16),
                             ("mel", tables.mel, torch.bfloat16)):
        if tsr.device.type != "cuda" or tsr.device != xp.device:
            raise ValueError(f"bf16 frontend kernel: {name} must be on "
                             f"{xp.device} (CUDA), got {tsr.device}")
        if tsr.dtype != dtype or not tsr.is_contiguous():
            raise ValueError(f"bf16 frontend kernel: {name} must be "
                             f"contiguous {dtype}, got {tsr.dtype}")
    k_lo, k_rows = tables.k_lo, tables.k_rows
    mel_blocks = sum(n for _, n in tables.mel_bands)
    if (k_lo, k_rows) != fast_rows(cfg) \
            or tables.dft.shape != (2 * FAST_BINS * k_rows,) \
            or len(tables.mel_bands) != -(-n_mels // 8) \
            or tables.mel.shape != (128 * mel_blocks,) \
            or seq_len.shape != (bsz,) or sp < n_fft:
        raise ValueError("bf16 frontend kernel: tables / seq_len / xp "
                         "shapes do not match the config")
    if xp.data_ptr() % 16 or tables.dft.data_ptr() % 16 \
            or tables.mel.data_ptr() % 8:
        raise ValueError("bf16 frontend kernel: xp and the DFT operand must "
                         "be 16-byte aligned, the mel fragments 8-byte")
    plan = plan or fast_plan(cfg)
    if plan is None or not 1 <= mel_blocks <= FAST_MAX_MEL_BLOCKS:
        raise ValueError(f"bf16 frontend kernel: n_fft={n_fft}, hop={hop}, "
                         f"n_mels={n_mels}, {k_rows} DFT rows are outside "
                         "the kernel's plan")
    lib = _fast_lib()
    if lib.vt_logmel_fast_plan_smem(n_fft, hop, n_mels, k_rows, plan.frames,
                                    plan.stages) != plan.smem:
        raise ValueError(f"bf16 frontend kernel: {plan} is not a plan of "
                         "csrc/frontend_fast.cu for this shape")
    t_out = (sp - n_fft) // hop + 1
    n_tiles = -(-t_out // FRAMES_PER_TILE)
    logmel = torch.empty((bsz, t_out, n_mels), dtype=torch.float32,
                         device=xp.device)
    parts = torch.empty((bsz, n_tiles, 2, n_mels), dtype=torch.float32,
                        device=xp.device)
    blocks = ctypes.c_int(0)
    bands = (ctypes.c_int * (2 * MAX_MELS // 8))(
        *[v for band in tables.mel_bands for v in band])
    with torch.cuda.device(xp.device):
        err = lib.vt_logmel_fast_forward(
            xp.data_ptr(), seq_len.data_ptr(), tables.dft.data_ptr(),
            tables.mel.data_ptr(), bands, mel_blocks, logmel.data_ptr(),
            parts.data_ptr(), bsz,
            sp, t_out, n_fft, hop, n_mels, k_lo, k_rows, plan.frames,
            plan.chunk_cols, plan.stages, plan.smem,
            float(cfg.log_zero_guard_value),
            int(cfg.log_zero_guard_type == "clamp"), ctypes.byref(blocks),
            torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(lib, err, "bf16 frontend kernel")
    log_mel_tiles_fast_cuda.launches += 1
    log_mel_tiles_fast_cuda.last_blocks = blocks.value
    return logmel, parts


log_mel_tiles_fast_cuda.launches = 0
log_mel_tiles_fast_cuda.last_blocks = 0


def _featurize(signal, lengths, cfg: FeaturizerConfig, tiles):
    """tiles(xp, seq_len) -> (logmel, parts): the kernel or its plain
    version, with its constants bound."""
    assert_audio_batch(signal, lengths, port="featurizer.input_signal")
    if not fused_supported(cfg):
        raise NotImplementedError(
            "fused frontend: config not covered (see fused_supported)")
    xp = preemphasize_and_pad(signal.to(torch.float32), cfg).contiguous()
    seq_len = feature_seq_len(lengths, cfg.hop_length)
    logmel, parts = tiles(xp, seq_len)

    # plain epilogue: Bessel-corrected per-feature normalization, the
    # per-tile partials merged two-pass (merge_tile_stats). This departs
    # from the Pallas wrapper's one-pass formula, which cancels on nearly
    # constant bins, and matches features.py::_normalize's two passes
    shift, offset, var = merge_tile_stats(parts, seq_len)
    feats = logmel
    if cfg.normalize == "per_feature":
        feats = (feats - shift[:, None, :] - offset[:, None, :]) \
            / (torch.sqrt(var)[:, None, :] + 1e-5)
    return mask_and_pad_time(feats, seq_len, logmel.shape[1], cfg), seq_len


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


def _plain_tiles(cfg, device, dft_matrix, mel_matrix, precision):
    if dft_matrix is None:
        dft_matrix = torch.as_tensor(_windowed_dft_matrix(cfg), device=device)
    if mel_matrix is None:
        mel_matrix = torch.as_tensor(_mel_matrix(cfg), device=device)
    plain = log_mel_tiles_plain if precision == "highest" \
        else log_mel_tiles_fast_plain
    return functools.partial(plain, dft=dft_matrix, mel=mel_matrix, cfg=cfg)


@functools.lru_cache(maxsize=16)
def _cfg_from_json(text: str) -> FeaturizerConfig:
    return FeaturizerConfig(**json.loads(text))


def _tiles_route(xp: torch.Tensor, seq_len: torch.Tensor,
                 tables: List[torch.Tensor], meta: List[int], cfg_json: str,
                 precision: str):
    """The log-mel tiles of `precision` from flat tables: on the CPU the
    plain version over [dft, mel]; on CUDA the FFT kernel over fft_tables'
    [window, twiddle, mel_index, mel_weight] and meta [taps, win_lo,
    win_hi], or the bf16 kernel over fast_tables' [dft, mel] and meta
    [k_lo, k_rows, then each mel band's (first step, steps)]."""
    cfg = _cfg_from_json(cfg_json)
    if xp.device.type == "cpu":
        return _plain_tiles(cfg, xp.device, tables[0], tables[1],
                            precision)(xp, seq_len)
    if precision == "highest":
        return log_mel_tiles_cuda(xp, seq_len, FFTTables(
            *tables, taps=meta[0], win_lo=meta[1], win_hi=meta[2]), cfg=cfg)
    bands = tuple(zip(meta[2::2], meta[3::2]))
    return log_mel_tiles_fast_cuda(xp, seq_len, FastTables(
        tables[0], tables[1], mel_bands=bands, k_lo=meta[0],
        k_rows=meta[1]), cfg=cfg)


_tiles_op = torch.library.custom_op(
    "vietasr::log_mel_tiles", _tiles_route, mutates_args=(),
    schema="(Tensor xp, Tensor seq_len, Tensor[] tables, int[] meta, "
           "str cfg_json, str precision) -> (Tensor, Tensor)")


@_tiles_op.register_fake
def _(xp, seq_len, tables, meta, cfg_json, precision):
    cfg = _cfg_from_json(cfg_json)
    t_out = (xp.shape[1] - cfg.fft_length) // cfg.hop_length + 1
    n_tiles = -(-t_out // FRAMES_PER_TILE)
    return (xp.new_empty((xp.shape[0], t_out, cfg.features)),
            xp.new_empty((xp.shape[0], n_tiles, 2, cfg.features)))


def _op_tiles(xp, seq_len, *, tables, cfg, precision):
    """tiles(xp, seq_len) through the custom op."""
    if isinstance(tables, FFTTables):
        flat = [tables.window, tables.twiddle, tables.mel_index,
                tables.mel_weight]
        meta = [tables.taps, tables.win_lo, tables.win_hi]
    elif isinstance(tables, FastTables):
        flat = [tables.dft, tables.mel]
        meta = [tables.k_lo, tables.k_rows] + [v for band in tables.mel_bands
                                               for v in band]
    else:
        flat, meta = list(tables), []
    return torch.ops.vietasr.log_mel_tiles(
        xp, seq_len, flat, meta, json.dumps(dataclasses.asdict(cfg)),
        precision)


def fused_log_mel_features(signal: torch.Tensor, lengths: torch.Tensor, *,
                           cfg: FeaturizerConfig,
                           tables=None,
                           dft_matrix: Optional[torch.Tensor] = None,
                           mel_matrix: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           training: bool = False,
                           precision: str = "highest"):
    """(B, S) float waveform + (B,) int lengths ->
    (feats (B, T_padded, n_mels) fp32, seq_len (B,) int32).

    CUDA tensors go through the kernel of `precision`: "highest", the FFT
    kernel (counted in `.launches`) with `tables` from fft_tables;
    "default", the bf16 kernel (counted in log_mel_tiles_fast_cuda.
    launches) with `tables` from fast_tables; either built on the signal's
    device unless given. CPU tensors go through the kernel's plain version
    with the DFT / mel matrices (built unless given).
    make_fused_featurizer builds the constants once. training=True adds
    the dither from `generator` before the kernel, as log_mel_features
    does before its DFT."""
    _check_precision(precision)
    if signal.device.type == "cpu":
        tiles = _plain_tiles(cfg, signal.device, dft_matrix, mel_matrix,
                             precision)
        if custom_ops.active():
            tiles = functools.partial(
                _op_tiles, tables=(tiles.keywords["dft"],
                                   tiles.keywords["mel"]),
                cfg=cfg, precision=precision)
    elif custom_ops.active():
        if tables is None:
            tables = (fft_tables if precision == "highest"
                      else fast_tables)(cfg, signal.device)
        tiles = functools.partial(_op_tiles, tables=tables, cfg=cfg,
                                  precision=precision)
    elif precision == "highest":
        if tables is None:
            tables = fft_tables(cfg, signal.device)
        tiles = functools.partial(log_mel_tiles_cuda, tables=tables,
                                  cfg=cfg)
    else:
        if tables is None:
            tables = fast_tables(cfg, signal.device)
        tiles = functools.partial(log_mel_tiles_fast_cuda, tables=tables,
                                  cfg=cfg)
    return _featurize(add_dither(signal, cfg, generator, training), lengths,
                      cfg, tiles)


fused_log_mel_features.launches = 0


def fused_log_mel_features_plain(signal: torch.Tensor, lengths: torch.Tensor,
                                 *, cfg: FeaturizerConfig,
                                 dft_matrix: Optional[torch.Tensor] = None,
                                 mel_matrix: Optional[torch.Tensor] = None,
                                 precision: str = "highest"):
    """The plain version of fused_log_mel_features, on any device."""
    _check_precision(precision)
    return _featurize(signal, lengths, cfg,
                      _plain_tiles(cfg, signal.device, dft_matrix,
                                   mel_matrix, precision))


def make_fused_featurizer(cfg: FeaturizerConfig, *, device=None,
                          precision: str = "highest"):
    """Same factory contract as features.make_featurizer, for the kernel of
    `precision` ("highest" or "default", as in JAX). The constants are
    built once here, on the device: the kernel's fft_tables or fast_tables
    on the GPU, the plain version's DFT and mel matrices on the CPU."""
    _check_precision(precision)
    dev = resolve_device(device)
    if dev.type == "cuda":
        tables = (fft_tables if precision == "highest" else fast_tables)(
            cfg, dev)
        return functools.partial(fused_log_mel_features, cfg=cfg,
                                 tables=tables, precision=precision)
    return functools.partial(
        fused_log_mel_features, cfg=cfg, precision=precision,
        dft_matrix=torch.as_tensor(_windowed_dft_matrix(cfg), device=dev),
        mel_matrix=torch.as_tensor(_mel_matrix(cfg), device=dev))
