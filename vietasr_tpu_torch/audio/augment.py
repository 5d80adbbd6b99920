"""Waveform augmentation on the host (counterpart of
vietasr_tpu/audio/augment.py): speed, pitch, gain, impulse-response
convolution, time shift, additive noise at a sampled SNR and white noise,
composed probabilistically by AudioAugmentor.

numpy and scipy, with the JAX package's draws from the same
`random.Random` / `np.random.RandomState` objects in the same order, so the
same seeds give the same waveforms. Speed perturbation resamples (tempo
and pitch together, the kaldi/espnet "speed perturb") on a 1/100 rate grid;
the pitch shift is a phase-vocoder time stretch resampled back to the
original length.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.signal import fftconvolve

from vietasr_tpu_torch.audio.io import AudioSegment, resample
from vietasr_tpu_torch.audio.manifest import read_manifest


class Perturbation:
    def max_augmentation_length(self, length: float) -> float:
        return length

    def perturb(self, segment: AudioSegment) -> None:
        raise NotImplementedError


class SpeedPerturbation(Perturbation):
    def __init__(self, min_speed_rate=0.85, max_speed_rate=1.15, rng=None):
        self._min_rate = min_speed_rate
        self._max_rate = max_speed_rate
        self._rng = random.Random() if rng is None else rng

    def max_augmentation_length(self, length):
        # resampling by rate yields ~length/rate samples, so the worst
        # case (longest output) is the SLOWEST rate, not the fastest
        return length / self._min_rate

    def perturb(self, segment):
        rate = self._rng.uniform(self._min_rate, self._max_rate)
        if rate <= 0:
            raise ValueError("speed rate must be positive")
        # resample by 1/rate: rate > 1 -> shorter (faster) audio.
        # The rate is quantized to a 1/100 grid so the polyphase
        # up/down factors stay <= ~o(100): a raw int(16000*rate) vs
        # 16000 is usually coprime, and resample_poly's FIR then needs
        # ~20*max(up,down) taps — ~320k taps, SECONDS per read, which
        # stalls on-the-fly augmentation. 21 discrete speeds
        # are standard augmentation practice (sox speed presets).
        num = max(1, int(round(rate * 100)))
        segment.samples = resample(segment.samples, num, 100)


def _phase_vocoder_stretch(x: np.ndarray, stretch: float,
                           n_fft: int = 512, hop: int = 128) -> np.ndarray:
    """Time-stretch `x` by `stretch` (>1 = longer) at constant pitch.

    Classic phase-vocoder: STFT at analysis hop, re-synthesize frames at
    the same hop while stepping the analysis position by hop/stretch and
    accumulating phase with the instantaneous-frequency correction
    (what librosa.effects.time_stretch does; self-contained here since
    librosa is not in the image)."""
    if stretch <= 0:
        raise ValueError("stretch must be positive")
    win = np.hanning(n_fft).astype(np.float32)
    pad = np.concatenate([np.zeros(n_fft // 2, np.float32),
                          x.astype(np.float32),
                          np.zeros(n_fft, np.float32)])
    n_frames = 1 + (len(pad) - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(
        pad, (n_frames, n_fft), (pad.strides[0] * hop, pad.strides[0]))
    spec = np.fft.rfft(frames * win, axis=1)             # (F, n_fft/2+1)

    # analysis positions on the synthesis frame grid
    t_out = np.arange(0, n_frames - 1, 1.0 / stretch)
    omega = 2 * np.pi * hop * np.arange(spec.shape[1]) / n_fft
    phase = np.angle(spec[0])
    out = np.empty((len(t_out), spec.shape[1]), np.complex64)
    for i, pos in enumerate(t_out):
        j = int(pos)
        frac = pos - j
        mag = (1 - frac) * np.abs(spec[j]) + frac * np.abs(spec[j + 1])
        out[i] = mag * np.exp(1j * phase)
        dphi = np.angle(spec[j + 1]) - np.angle(spec[j]) - omega
        dphi -= 2 * np.pi * np.round(dphi / (2 * np.pi))
        phase += omega + dphi

    # overlap-add inverse with squared-window normalization
    y_len = n_fft + hop * (len(t_out) - 1)
    y = np.zeros(y_len, np.float32)
    norm = np.zeros(y_len, np.float32)
    frames_t = np.fft.irfft(out, n=n_fft, axis=1).astype(np.float32) * win
    for i in range(len(t_out)):
        y[i * hop:i * hop + n_fft] += frames_t[i]
        norm[i * hop:i * hop + n_fft] += win ** 2
    y = y / np.maximum(norm, 1e-8)
    start = n_fft // 2
    want = int(round(len(x) * stretch))
    return y[start:start + want]


class PitchPerturbation(Perturbation):
    """Pitch shift WITHOUT tempo change: phase-vocoder
    time-stretch by the pitch factor, then resample back to the original
    length — duration preserved, pitch scaled by 2^(steps/12)."""

    def __init__(self, min_steps=-2.0, max_steps=2.0, sample_rate=16000,
                 rng=None):
        self._min = min_steps
        self._max = max_steps
        self._sr = sample_rate
        self._rng = random.Random() if rng is None else rng

    def perturb(self, segment):
        steps = self._rng.uniform(self._min, self._max)
        segment.samples = pitch_shift(segment.samples, steps,
                                      sample_rate=self._sr)


def pitch_shift(x: np.ndarray, n_steps: float,
                sample_rate: int = 16000) -> np.ndarray:
    """Shift pitch by n_steps semitones at constant duration."""
    factor = 2.0 ** (n_steps / 12.0)
    if abs(factor - 1.0) < 1e-6:
        return np.asarray(x, np.float32)
    stretched = _phase_vocoder_stretch(np.asarray(x, np.float32), factor)
    # compress/expand time back to the original length: pitch *= factor
    # (the stretched signal plays at factor*sr in the original duration)
    y = resample(stretched, max(int(round(sample_rate * factor)), 1),
                 sample_rate)
    if len(y) < len(x):
        y = np.pad(y, (0, len(x) - len(y)))
    return y[: len(x)].astype(np.float32)


class GainPerturbation(Perturbation):
    def __init__(self, min_gain_dbfs=-10, max_gain_dbfs=10, rng=None):
        self._min = min_gain_dbfs
        self._max = max_gain_dbfs
        self._rng = random.Random() if rng is None else rng

    def perturb(self, segment):
        gain = self._rng.uniform(self._min, self._max)
        segment.samples = segment.samples * (10.0 ** (gain / 20.0))


class ShiftPerturbation(Perturbation):
    def __init__(self, min_shift_ms=-5.0, max_shift_ms=5.0, rng=None):
        self._min = min_shift_ms
        self._max = max_shift_ms
        self._rng = random.Random() if rng is None else rng

    def perturb(self, segment):
        shift_ms = self._rng.uniform(self._min, self._max)
        if abs(shift_ms) / 1000.0 > segment.duration:
            return
        k = int(shift_ms * segment.sample_rate // 1000)
        x = segment.samples
        if k < 0:
            x[-k:] = x[:k]
            x[:-k] = 0
        elif k > 0:
            x[:-k] = x[k:]
            x[-k:] = 0
        segment.samples = x


class WhiteNoisePerturbation(Perturbation):
    def __init__(self, min_level=-90, max_level=-46, rng=None):
        self.min_level = int(min_level)
        self.max_level = int(max_level)
        self._rng = np.random.RandomState() if rng is None else rng

    def perturb(self, segment):
        level_db = self._rng.randint(self.min_level, self.max_level)
        noise = self._rng.randn(len(segment.samples)) * (10.0 ** (level_db / 20.0))
        segment.samples = segment.samples + noise.astype(np.float32)


class NoisePerturbation(Perturbation):
    """Additive real-noise at a sampled SNR, noise drawn from a manifest."""

    def __init__(self, manifest_path=None, min_snr_db=40, max_snr_db=50,
                 max_gain_db=300.0, rng=None):
        self._entries = read_manifest(manifest_path) if manifest_path else []
        self._rng = random.Random() if rng is None else rng
        self._min_snr_db = min_snr_db
        self._max_snr_db = max_snr_db
        self._max_gain_db = max_gain_db

    def perturb(self, segment):
        if not self._entries:
            return
        snr_db = self._rng.uniform(self._min_snr_db, self._max_snr_db)
        rec = self._rng.sample(self._entries, 1)[0]
        noise = AudioSegment.from_file(rec.audio_file,
                                       target_sr=segment.sample_rate)
        gain_db = min(segment.rms_db - noise.rms_db - snr_db,
                      self._max_gain_db)
        if noise.duration > segment.duration:
            start = self._rng.uniform(0.0, noise.duration - segment.duration)
            noise.subsegment(start, start + segment.duration)
        noise.gain_db(gain_db)
        n = min(len(noise.samples), len(segment.samples))
        out = segment.samples.copy()
        out[:n] += noise.samples[:n]
        segment.samples = out


class ImpulsePerturbation(Perturbation):
    """Room impulse response convolution."""

    def __init__(self, manifest_path=None, rng=None):
        self._entries = read_manifest(manifest_path) if manifest_path else []
        self._rng = random.Random() if rng is None else rng

    def perturb(self, segment):
        if not self._entries:
            return
        rec = self._rng.sample(self._entries, 1)[0]
        impulse = AudioSegment.from_file(rec.audio_file,
                                         target_sr=segment.sample_rate)
        segment.samples = fftconvolve(
            segment.samples, impulse.samples, "full").astype(np.float32)


perturbation_types = {
    "speed": SpeedPerturbation,
    "pitch": PitchPerturbation,
    "gain": GainPerturbation,
    "impulse": ImpulsePerturbation,
    "shift": ShiftPerturbation,
    "noise": NoisePerturbation,
    "white_noise": WhiteNoisePerturbation,
}


class AudioAugmentor:
    """Probabilistic pipeline: [(prob, Perturbation), ...]."""

    def __init__(self, perturbations: Optional[List[Tuple[float, Perturbation]]] = None,
                 rng=None):
        self._rng = random.Random() if rng is None else rng
        self._pipeline = perturbations or []

    def __call__(self, samples: np.ndarray, sample_rate: int) -> np.ndarray:
        seg = AudioSegment(samples=samples, sample_rate=sample_rate)
        self.perturb(seg)
        return seg.samples

    def perturb(self, segment: AudioSegment) -> None:
        for prob, p in self._pipeline:
            if self._rng.random() < prob:
                p.perturb(segment)

    def max_augmentation_length(self, length: float) -> float:
        for _, p in self._pipeline:
            length = p.max_augmentation_length(length)
        return length

    @classmethod
    def from_config(cls, config: Sequence[dict]) -> "AudioAugmentor":
        ptbs = []
        for p in config:
            if p["aug_type"] not in perturbation_types:
                continue
            ptbs.append((p["prob"],
                         perturbation_types[p["aug_type"]](**p.get("cfg", {}))))
        return cls(perturbations=ptbs)
