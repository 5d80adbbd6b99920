"""Host-side audio I/O: wav decode, resample, silence trim (the port's copy
of vietasr_tpu/audio/io.py, numpy and scipy).

Rebuilds the capabilities of the reference AudioSegment (its
segment.py:10-183) without libsndfile or librosa:

- WAV decode via scipy.io.wavfile (PCM8/16/32, float32/64), int scaled to
  [-1, 1] exactly as _convert_samples_to_float32 does (segment.py:62-77).
- Resampling as a polyphase FIR (scipy.signal.resample_poly) — same family
  of algorithm librosa's resample uses under the hood.
- trim_silence replicating librosa.effects.trim semantics: frame-level RMS
  vs max-RMS threshold at top_db (default 60, segment.py:28-29).

MP3 decodes through the system libmpg123 (audio/mp3.py ctypes binding);
the reference shelled out to ffmpeg via audioread for this
(README.md:31, infer.py:200).
"""

from __future__ import annotations

import io as _io
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def _to_float32(samples: np.ndarray) -> np.ndarray:
    """Int PCM -> [-1, 1] float32 (reference segment.py:62-77 scaling)."""
    if np.issubdtype(samples.dtype, np.integer):
        bits = np.iinfo(samples.dtype).bits
        if samples.dtype == np.uint8:
            return (samples.astype(np.float32) - 128.0) / 128.0
        return samples.astype(np.float32) / (2.0 ** (bits - 1))
    return samples.astype(np.float32)


def _read_g711_wav(f) -> Tuple[np.ndarray, int]:
    """Minimal RIFF walk for G.711 WAVs (fmt tags 7 = mu-law, 6 = A-law),
    which scipy.io.wavfile rejects. The reference read these via
    libsndfile (segment.py:89-100). Returns (float32 mono, sr)."""
    import struct

    from vietasr_tpu_torch.audio.g711 import alaw_decode, ulaw_decode

    f.seek(0)
    riff, _, wave_id = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave_id != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    tag = channels = sr = None
    data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            fmt = f.read(size)
            tag, channels, sr = struct.unpack("<HHI", fmt[:8])
        elif cid == b"data":
            data = f.read(size)
        else:
            f.seek(size + (size & 1), 1)
        if size & 1 and cid in (b"fmt ", b"data"):
            f.seek(1, 1)
    if tag not in (6, 7) or data is None:
        raise ValueError(f"unsupported wav format tag {tag}")
    codes = np.frombuffer(data, np.uint8)
    pcm = ulaw_decode(codes) if tag == 7 else alaw_decode(codes)
    samples = pcm.astype(np.float32) / 32768.0
    if channels and channels > 1:
        samples = samples[: len(samples) // channels * channels]
        samples = samples.reshape(-1, channels).mean(axis=1)
    return samples, int(sr)


def read_wav(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Read a wav file (path, file-like, or raw bytes) -> (float32 mono, sr).
    PCM/float via scipy; G.711 mu-law/A-law (fmt tags 7/6) via the
    built-in codec (audio/g711.py)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = _io.BytesIO(path_or_bytes)
    import warnings
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", wavfile.WavFileWarning)
            sr, samples = wavfile.read(path_or_bytes)
    except ValueError:
        f = path_or_bytes if hasattr(path_or_bytes, "seek") \
            else open(path_or_bytes, "rb")
        try:
            try:
                return _read_g711_wav(f)
            except ValueError:
                # Not any kind of RIFF: sniff for mp3 content so
                # extension-less uploads still decode.
                from vietasr_tpu_torch.audio import mp3 as _mp3
                f.seek(0)
                blob = f.read()
                # frame sync may sit past leading junk (common in
                # call-center dumps — mpg123 itself resyncs); attempt a
                # decode whenever a sync appears in the head, and fall
                # through to the original error if it wasn't mp3
                if _mp3.looks_like_mp3(blob[:4]) \
                        or _mp3.find_frame_sync(blob) >= 0:
                    try:
                        return _mp3.decode_mp3(blob)
                    except (ValueError, NotImplementedError,
                            RuntimeError):
                        # RuntimeError covers mpg123 session failures on
                        # non-mp3 bytes that happened to contain a sync
                        # pattern — fall through to the original wav error
                        pass
                raise
        finally:
            if f is not path_or_bytes:
                f.close()
    samples = _to_float32(np.asarray(samples))
    if samples.ndim >= 2:
        samples = samples.mean(axis=1)
    return samples, sr


def read_audio(path, *, target_sr: Optional[int] = None,
               offset: float = 0.0, duration: float = 0.0,
               trim: bool = False, trim_db: float = 60.0
               ) -> Tuple[np.ndarray, int]:
    """Full decode pipeline: wav -> mono float32 -> offset/duration slice ->
    resample -> optional trim."""
    p = str(path)
    if p.lower().endswith(".mp3"):
        from vietasr_tpu_torch.audio.mp3 import decode_mp3
        with open(p, "rb") as f:
            samples, sr = decode_mp3(f.read())
    else:
        samples, sr = read_wav(p)
    if offset or duration:
        start = int(offset * sr)
        stop = start + int(duration * sr) if duration else len(samples)
        samples = samples[start:stop]
    if target_sr is not None and target_sr != sr:
        samples = resample(samples, sr, target_sr)
        sr = target_sr
    if trim:
        samples = trim_silence(samples, top_db=trim_db)
    return samples, sr


def resample(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase FIR resampling (e.g. 8 kHz call-center audio -> 16 kHz)."""
    if orig_sr == target_sr:
        return samples
    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(samples.astype(np.float32),
                         target_sr // g, orig_sr // g).astype(np.float32)


def trim_silence(samples: np.ndarray, *, top_db: float = 60.0,
                 frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """librosa.effects.trim semantics: drop leading/trailing frames whose
    RMS is more than top_db below the max frame RMS."""
    if len(samples) == 0:
        return samples
    n_frames = 1 + max(len(samples) - frame_length, 0) // hop_length
    rms = np.empty(n_frames)
    for i in range(n_frames):
        frame = samples[i * hop_length : i * hop_length + frame_length]
        rms[i] = np.sqrt(np.mean(frame.astype(np.float64) ** 2) + 1e-20)
    threshold = rms.max() * (10.0 ** (-top_db / 20.0))
    loud = np.nonzero(rms > threshold)[0]
    if len(loud) == 0:
        return samples[:0]
    start = loud[0] * hop_length
    stop = min(len(samples), (loud[-1] + 1) * hop_length + frame_length)
    return samples[start:stop]


@dataclass
class AudioSegment:
    """Mono float32 audio with its sample rate (reference AudioSegment API)."""

    samples: np.ndarray
    sample_rate: int

    @classmethod
    def from_file(cls, path, *, target_sr: Optional[int] = None,
                  offset: float = 0.0, duration: float = 0.0,
                  trim: bool = False) -> "AudioSegment":
        samples, sr = read_audio(path, target_sr=target_sr, offset=offset,
                                 duration=duration, trim=trim)
        return cls(samples=samples, sample_rate=sr)

    @property
    def num_samples(self) -> int:
        return len(self.samples)

    @property
    def duration(self) -> float:
        return len(self.samples) / float(self.sample_rate)

    @property
    def rms_db(self) -> float:
        mean_sq = float(np.mean(self.samples ** 2) + 1e-20)
        return 10.0 * np.log10(mean_sq)

    def gain_db(self, gain: float) -> None:
        self.samples = self.samples * (10.0 ** (gain / 20.0))

    def pad(self, pad_size: int, symmetric: bool = False) -> None:
        self.samples = np.pad(
            self.samples,
            (pad_size if symmetric else 0, pad_size), mode="constant")

    def subsegment(self, start: Optional[float] = None,
                   end: Optional[float] = None) -> None:
        start = 0.0 if start is None else start
        end = self.duration if end is None else end
        if start < 0.0:
            start += self.duration
        if end < 0.0:
            end += self.duration
        s = int(round(start * self.sample_rate))
        e = int(round(end * self.sample_rate))
        self.samples = self.samples[s:e]
