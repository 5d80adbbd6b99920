"""Long-form audio: chunked inference with receptive-field overlap
(counterpart of vietasr_tpu/streaming.py).

QuartzNet is fully convolutional, so audio of any length is cut into
fixed overlapping chunks, each chunk runs the normal forward, the overlap
margins are dropped in encoder-frame space, and the kept log-probs are
concatenated and decoded once. Per-feature normalization is chunk-local
instead of utterance-global (the JAX package's documented deviation).

The fused path (`_longform_program`): the whole utterance goes to the
device once, in its wire dtype (int16 PCM and uint8 G.711 stay 2 and 1
bytes a sample) and its native rate; there it is decoded
(ops/g711.py), resampled (ops/resample.py), viewed as its chunks (one
`unfold` of the padded buffer), featurized (the frontend kernel on the
GPU), run through the encoder as one batch of n_spans rows (the repeat
kernel on the GPU), stitched by one gather, and greedy-decoded; the
stitched length and the greedy ids come back in one packed copy. The
static parts of each program (the stitch index, the resampler's weights)
are cached per (n_spans, chunk, overlap, want_lp, in_sr, in_dtype), as JAX
caches its compiled programs. Signals of one chunk or of more than
FUSED_MAX_SPANS chunks take the grouped path (`long_form_log_probs`):
host-side conversion, then max_batch chunks per forward through
`Transcriber.log_probs`.

A Conformer goes the same way, its spans stitched on its 4x subsampling
(`frame_stride`): the stitched posterior has the offline forward's frame
count. This differs from the JAX package by design: JAX reads the stride
from the Jasper blocks (`encoder_stride`), which a Conformer config has
none of, so it stitches on stride 1 and drops frames (900 of 1,000 over
40 s, tests/test_torch_streaming_conformer.py). Each span of a Conformer
attends within itself only, so the stitched posterior is that of the
spans, not of the offline forward over the whole signal.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vietasr_tpu_torch.config import EncoderConfig, ModelConfig
from vietasr_tpu_torch.models import model_apply
from vietasr_tpu_torch.ops.g711 import decode_wire
from vietasr_tpu_torch.ops.greedy import greedy_decode, ids_to_text
from vietasr_tpu_torch.ops.resample import make_device_resampler

# Above this many chunks one program would hold the whole posterior at
# once; longer signals take the grouped path
FUSED_MAX_SPANS = 64


def receptive_field_frames(cfg: EncoderConfig) -> int:
    """Receptive field of the encoder in input (mel-frame) units:
    rf += (k-1) * dilation * jump per conv; jump *= stride."""
    rf, jump = 1, 1
    for b in cfg.blocks:
        k = b.effective_kernel
        for _ in range(b.repeat):
            rf += (k - 1) * b.dilation * jump
            jump *= b.stride
    return rf


def encoder_stride(cfg: EncoderConfig) -> int:
    s = 1
    for b in cfg.blocks:
        s *= b.stride ** b.repeat
    return s


def frame_stride(cfg: ModelConfig) -> int:
    """Mel frames per encoder frame: a Conformer's subsampling (4x in
    both its conv2d and its stack mode), a QuartzNet's product of block
    strides."""
    if cfg.architecture == "conformer":
        factor = cfg.conformer.subsampling_factor
        if factor != 4:
            raise ValueError(f"subsampling_factor {factor}: the Conformer "
                             "subsamples 4x (models/conformer.py)")
        return factor
    return encoder_stride(cfg.encoder)


def chunk_spans(n_samples: int, chunk: int, overlap: int
                ) -> List[Tuple[int, int, int, int]]:
    """Split [0, n_samples) into overlapping chunks: (start, stop,
    keep_from, keep_to) per chunk, keep_* being sample offsets within the
    chunk whose outputs are kept (the stitch points sit mid-overlap)."""
    if n_samples <= chunk:
        return [(0, n_samples, 0, n_samples)]
    step = chunk - 2 * overlap
    if step <= 0:
        raise ValueError("overlap too large for chunk size")
    spans = []
    start = 0
    while True:
        stop = min(start + chunk, n_samples)
        keep_from = 0 if start == 0 else overlap
        keep_to = stop - start if stop == n_samples else chunk - overlap
        spans.append((start, stop, keep_from, keep_to))
        if stop == n_samples:
            break
        start += step
    return spans


def _longform_grid(transcriber, chunk_seconds: float,
                   overlap_seconds: float) -> Tuple[int, int, int]:
    """(chunk, overlap, grid) in samples, rounded to the stitch grid
    hop * encoder stride (off-grid stitch points duplicate or drop
    boundary frames)."""
    sr = transcriber.cfg.featurizer.sample_rate
    hop = transcriber.cfg.featurizer.hop_length
    grid = hop * frame_stride(transcriber.cfg)
    chunk = max(int(chunk_seconds * sr) // grid, 2) * grid
    overlap = max(int(overlap_seconds * sr) // grid, 1) * grid
    return chunk, overlap, grid


class _LongformProgram:
    """One long-form pipeline for a fixed span count and input format:
    `(flat device buffer, last chunk's length) -> packed greedy result`
    or `-> (stitched log-probs, total)` with want_lp."""

    def __init__(self, transcriber, n_spans: int, chunk: int, overlap: int,
                 want_lp: bool, in_sr: Optional[int], in_dtype: str):
        cfg = transcriber.cfg
        self.tr = transcriber
        self.n_spans, self.chunk, self.want_lp = n_spans, chunk, want_lp
        self.in_dtype = in_dtype
        grid = cfg.featurizer.hop_length * frame_stride(cfg)
        self.step = chunk - 2 * overlap
        self.ov_f = overlap // grid        # chunk/overlap: grid multiples
        self.chunk_f = chunk // grid
        self.n_pad = (n_spans - 1) * self.step + chunk
        self.resample = None
        if in_sr is not None and in_sr != cfg.featurizer.sample_rate:
            self.resample = make_device_resampler(
                in_sr, cfg.featurizer.sample_rate, device=transcriber.device)
        # keep ranges in encoder frames (chunk_spans + the ceil mapping of
        # long_form_log_probs); the frames of every chunk before the last
        # are static, the last one's share is clamp(enc_len - ov_f, ...)
        self.ranges = [(0 if g == 0 else self.ov_f,
                        self.chunk_f if g == n_spans - 1
                        else self.chunk_f - self.ov_f)
                       for g in range(n_spans)]
        self.static_prefix = sum(b - a for a, b in self.ranges[:-1])
        self._idx = {}                     # tc -> stitch index on device

    def _stitch_index(self, tc: int) -> torch.Tensor:
        idx = self._idx.get(tc)
        if idx is None:
            idx = np.concatenate([
                np.arange(a, min(b, tc), dtype=np.int64) + g * tc
                for g, (a, b) in enumerate(self.ranges)])
            idx = self._idx[tc] = torch.from_numpy(idx).to(self.tr.device)
        return idx

    @torch.inference_mode()
    def __call__(self, flat: torch.Tensor, last_len: int):
        tr = self.tr
        x = decode_wire(flat, self.in_dtype)
        if self.resample is not None:
            x = self.resample(x)[: self.n_pad]
        chunks = x.unfold(0, self.chunk, self.step)     # (n_spans, chunk)
        lens = torch.full((self.n_spans,), self.chunk, dtype=torch.int32,
                          device=x.device)
        lens[-1] = last_len
        feats, flens = tr._featurize(chunks, lens)
        kwargs = {"block_impl": tr.opts.block_impl} \
            if tr.cfg.architecture == "quartznet" else {}
        lp, enc_lens = model_apply(tr.variables, feats, flens, cfg=tr.cfg,
                                   compute_dtype=tr.compute_dtype, **kwargs)
        tc = lp.shape[1]
        stitched = lp.reshape(self.n_spans * tc, lp.shape[2]).index_select(
            0, self._stitch_index(tc))
        total = self.static_prefix + torch.clamp(
            enc_lens[-1:] - self.ov_f, 0, min(self.chunk_f, tc) - self.ov_f)
        if self.want_lp:
            return stitched, total[0]
        preds, keep = greedy_decode(stitched[None], total,
                                    blank=tr.cfg.num_classes)
        # one packed buffer, one device-to-host copy
        return torch.cat([preds[0], keep[0].to(torch.int32),
                          total.to(torch.int32)])


def _longform_program(transcriber, n_spans: int, chunk: int, overlap: int,
                      want_lp: bool, in_sr: Optional[int] = None,
                      in_dtype: str = "float32") -> _LongformProgram:
    cache = transcriber.__dict__.setdefault("_longform_programs", {})
    key = (n_spans, chunk, overlap, want_lp, in_sr, in_dtype)
    if key not in cache:
        cache[key] = _LongformProgram(transcriber, n_spans, chunk, overlap,
                                      want_lp, in_sr, in_dtype)
    return cache[key]


def _prep_longform(transcriber, signal: np.ndarray,
                   signal_sr: Optional[int], chunk: int, overlap: int,
                   signal_encoding: Optional[str] = None):
    """Host staging for the fused path: (n_spans, flat_in, last_len,
    in_sr, in_dtype), flat_in being the buffer to upload in its native
    dtype and rate, or None when the signal takes the grouped path (one
    chunk, or more than FUSED_MAX_SPANS)."""
    sr = transcriber.cfg.featurizer.sample_rate
    in_sr = signal_sr if signal_sr is not None else sr
    if in_sr == sr:
        n_model = len(signal)
    else:
        g = math.gcd(int(in_sr), int(sr))
        up, down = sr // g, in_sr // g
        n_model = -(-len(signal) * up // down)    # resampled length
    spans = chunk_spans(n_model, chunk, overlap)
    if not 1 < len(spans) <= FUSED_MAX_SPANS:
        return None
    step = chunk - 2 * overlap
    n_pad = (len(spans) - 1) * step + chunk
    n_pad_in = n_pad if in_sr == sr else -(-n_pad * down // up)
    if signal.dtype == np.uint8:
        if signal_encoding not in ("ulaw", "alaw"):
            raise ValueError(
                "uint8 signals are G.711 wire bytes; pass "
                "signal_encoding='ulaw' or 'alaw'")
        in_dtype = signal_encoding
        # the law's code for silence
        flat = np.full((n_pad_in,), 0xFF if signal_encoding == "ulaw"
                       else 0x55, np.uint8)
    elif signal.dtype == np.int16:
        in_dtype = "int16"
        flat = np.zeros((n_pad_in,), np.int16)
    else:
        in_dtype = "float32"
        flat = np.zeros((n_pad_in,), np.float32)
    flat[: len(signal)] = signal
    last_len = n_model - (len(spans) - 1) * step
    return len(spans), flat, last_len, in_sr, in_dtype


def _run_fused(transcriber, prep, chunk: int, overlap: int, want_lp: bool):
    n_spans, flat, last_len, in_sr, in_dtype = prep
    fn = _longform_program(transcriber, n_spans, chunk, overlap, want_lp,
                           in_sr=in_sr, in_dtype=in_dtype)
    return fn(torch.from_numpy(flat).to(transcriber.device), last_len)


def _unpack_greedy(packed: np.ndarray, labels) -> str:
    t_st = (packed.shape[0] - 1) // 2
    preds, keep = packed[:t_st], packed[t_st: 2 * t_st].astype(bool)
    return ids_to_text(preds[keep], labels)


def transcribe_long_batch(
    transcriber,
    signals: Sequence[np.ndarray],
    *,
    chunk_seconds: float = 15.0,
    overlap_seconds: float = 2.0,
    signal_sr: Optional[int] = None,
    signal_encoding: Optional[str] = None,
) -> List[str]:
    """Greedy long-form decode of several utterances: every fused program
    is queued on the device before any result is read back, so the host
    stages utterance i + 1 while the card runs utterance i. Utterances
    that do not fit the fused path (one chunk, more than FUSED_MAX_SPANS,
    or a non-greedy decoder) go through transcribe_long one by one.

    signal_sr: the native rate of `signals` when it differs from the
    model's (resampled on the device). int16 arrays are PCM, uint8 arrays
    G.711 wire bytes (signal_encoding 'ulaw' or 'alaw'); both are uploaded
    as they are and converted on the device."""
    chunk, overlap, _ = _longform_grid(transcriber, chunk_seconds,
                                       overlap_seconds)
    decoder = transcriber.opts.decoder
    out: List[Optional[str]] = [None] * len(signals)
    pending = []                                   # (index, device packed)
    for i, signal in enumerate(signals):
        prep = None if decoder != "greedy" else _prep_longform(
            transcriber, signal, signal_sr, chunk, overlap, signal_encoding)
        if prep is None:
            out[i] = transcribe_long(transcriber, signal,
                                     chunk_seconds=chunk_seconds,
                                     overlap_seconds=overlap_seconds,
                                     signal_sr=signal_sr,
                                     signal_encoding=signal_encoding)
            continue
        pending.append((i, _run_fused(transcriber, prep, chunk, overlap,
                                      want_lp=False)))
    for i, packed in pending:
        out[i] = _unpack_greedy(packed.cpu().numpy(), transcriber.cfg.labels)
    return out                                     # type: ignore


def transcribe_long(
    transcriber,
    signal: np.ndarray,
    *,
    chunk_seconds: float = 15.0,
    overlap_seconds: float = 2.0,
    signal_sr: Optional[int] = None,
    signal_encoding: Optional[str] = None,
) -> str:
    """Chunked long-form transcription through a Transcriber, with its
    decoder: greedy on the device, `device_beam` over the stitched
    log-probs (the beam kernel on the GPU), or the host `beam`. Input
    formats as in transcribe_long_batch (converted on the device on the
    fused path, on the host on the grouped one)."""
    chunk, overlap, _ = _longform_grid(transcriber, chunk_seconds,
                                       overlap_seconds)
    decoder = transcriber.opts.decoder
    labels = transcriber.cfg.labels
    prep = _prep_longform(transcriber, signal, signal_sr, chunk, overlap,
                          signal_encoding)
    if prep is not None:
        if decoder == "greedy":
            packed = _run_fused(transcriber, prep, chunk, overlap, False)
            return _unpack_greedy(packed.cpu().numpy(), labels)
        log_probs, total = _run_fused(transcriber, prep, chunk, overlap,
                                      True)
        total = int(total)
    else:
        # the grouped path takes model-rate float32: convert on the host
        if signal.dtype == np.uint8:
            from vietasr_tpu_torch.audio.g711 import alaw_decode, ulaw_decode

            if signal_encoding not in ("ulaw", "alaw"):
                raise ValueError(
                    "uint8 signals are G.711 wire bytes; pass "
                    "signal_encoding='ulaw' or 'alaw'")
            dec = ulaw_decode if signal_encoding == "ulaw" else alaw_decode
            signal = dec(signal).astype(np.float32) / 32768.0
        elif signal.dtype == np.int16:
            signal = signal.astype(np.float32) / 32768.0
        sr = transcriber.cfg.featurizer.sample_rate
        if signal_sr is not None and signal_sr != sr:
            from vietasr_tpu_torch.audio.io import resample

            signal = resample(signal, signal_sr, sr)
        log_probs, total = long_form_log_probs(
            transcriber, signal, chunk_seconds=chunk_seconds,
            overlap_seconds=overlap_seconds, device=True)
    if decoder == "device_beam":
        # the static stitched length, masked by `total`
        lens = torch.tensor([total], dtype=torch.int32,
                            device=log_probs.device)
        return transcriber._device_beam(log_probs[None], lens)[0]
    if transcriber._decoder is not None:
        return transcriber._decoder.decode(
            log_probs[:total].float().cpu().numpy())
    # greedy on the device: only the (T,) ids and mask cross to the host
    preds, keep = greedy_decode(
        log_probs[None], torch.tensor([total], device=log_probs.device),
        blank=transcriber.cfg.num_classes)
    return ids_to_text(preds[0].cpu().numpy()[keep[0].cpu().numpy()], labels)


def long_form_log_probs(transcriber, signal: np.ndarray, *,
                        chunk_seconds: float, overlap_seconds: float,
                        device: bool = False):
    """Stitched (T_total, V) log-probs for audio of any length: the chunks
    go through the encoder max_batch at a time (rows past the last chunk
    have length 0). device=True keeps the posterior on the device (a
    tensor); else numpy. Returns (log_probs, T_total)."""
    hop = transcriber.cfg.featurizer.hop_length
    enc_stride = frame_stride(transcriber.cfg)
    chunk, overlap, _ = _longform_grid(transcriber, chunk_seconds,
                                       overlap_seconds)
    spans = chunk_spans(len(signal), chunk, overlap)
    group = max(int(transcriber.opts.max_batch), 1)
    pieces = [None] * len(spans)
    for g0 in range(0, len(spans), group):
        g_spans = spans[g0: g0 + group]
        batch = np.zeros((group, chunk), np.float32)
        lens = np.zeros((group,), np.int32)
        for i, (start, stop, _, _) in enumerate(g_spans):
            batch[i, : stop - start] = signal[start:stop]
            lens[i] = stop - start
        lp, enc_lens = transcriber.log_probs(batch, lengths=lens,
                                             as_numpy=not device)
        for i, (start, stop, keep_from, keep_to) in enumerate(g_spans):
            n_valid = int(enc_lens[i])
            # sample offsets -> encoder frames: ceil(x / hop) / stride
            f_from = int(math.ceil(keep_from / hop / enc_stride))
            f_to = min(n_valid, int(math.ceil(keep_to / hop / enc_stride)))
            pieces[g0 + i] = lp[i, f_from:f_to]
    out = torch.cat(pieces, 0) if device else np.concatenate(pieces, 0)
    return out, out.shape[0]
