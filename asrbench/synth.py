"""The one traffic generator: utterances of the synthetic language, drawn
from a seed.

Each Vietnamese label maps to a formant signature (a copy of the study's
v2 signatures: two tones on ratio-1.35 log grids, a chirp direction and a
gated 5.0-6.4 kHz noise band). A word is its characters' signatures end to
end; an utterance is words drawn from the corpus below, with silence gaps
of 30-80 ms between them, filled up to its drawn length, under a noise
floor. Every utterance comes with its transcript.

The lengths are not drawn: a mix of n utterances takes the n quantiles of
a log-uniform distribution on [min_s, max_s], so every seed sees the same
multiset of lengths (the same work), and the seed draws only the words,
the gaps, the noise and the order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

SR = 16000

# the study's sentences, which are also chip_smoke's VI_CORPUS
CORPUS = [
    "xin chào các bạn", "bản tin thời sự hôm nay", "chào mừng quý vị",
    "tin tức trong ngày", "cảm ơn các bạn đã lắng nghe",
    "thời tiết hà nội hôm nay", "chúc các bạn một ngày tốt lành",
    "đây là đài tiếng nói việt nam", "tin thể thao quốc tế",
    "giá xăng dầu trong nước", "tình hình giao thông buổi sáng",
    "xin kính chào quý vị và các bạn", "bản tin cuối ngày",
    "chương trình ca nhạc theo yêu cầu", "dự báo thời tiết ngày mai",
]
WORDS = sorted(set(" ".join(CORPUS).split()))

GAP_SAMPLES = (480, 1280)     # silence between words, [lo, hi)
NOISE_STD = 3e-4              # the floor under every sample


def char_wave(ci: int, sr: int = SR) -> np.ndarray:
    """The v2 signature of label index `ci`: f1, f2 on log grids with
    ratio-1.35 spacing, the f2 chirp's direction (down / flat / up) and a
    gated 5.0-6.4 kHz noise band: 5 x 5 x 3 x 2 = 150 codes, 70-110 ms by a
    hash of the index."""
    h = (ci * 2654435761) & 0xFFFFFFFF
    dur = 0.07 + 0.04 * ((h >> 8) % 7) / 6.0
    n = int(dur * sr)
    t = np.arange(n) / sr
    i1 = ci % 5
    i2 = (ci // 5) % 5
    chirp = (ci // 25) % 3 - 1
    noise_on = (ci // 75) % 2
    f1 = 300.0 * 1.35 ** i1
    f2 = 1200.0 * 1.35 ** i2
    env = np.clip(np.minimum(np.minimum(t / 0.012, (dur - t) / 0.02),
                             1.0), 0.0, 1.0)
    phase2 = 2 * np.pi * f2 * (t + 0.12 * chirp * t * t / (2 * dur))
    x = (0.45 * np.sin(2 * np.pi * f1 * t)
         + 0.35 * np.sin(phase2)
         + 0.10 * np.sin(2 * np.pi * 2 * f1 * t))
    if noise_on:
        rng = np.random.RandomState((ci * 7919 + 13) & 0x7FFFFFFF)
        spec = np.fft.rfft(rng.randn(n))
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        spec[(freqs < 5000.0) | (freqs > 6400.0)] = 0.0
        band = np.fft.irfft(spec, n)
        band /= max(float(np.sqrt(np.mean(band ** 2))), 1e-9)
        x = x + 0.18 * band
    return (0.25 * x * env).astype(np.float32)


def word_bank(labels: Sequence[str]) -> Dict[str, np.ndarray]:
    """word -> waveform, for every corpus word whose characters are all
    labels."""
    idx = {c: i for i, c in enumerate(labels)}
    return {w: np.concatenate([char_wave(idx[c]) for c in w])
            for w in WORDS if all(c in idx for c in w)}


def quantile_lengths(n: int, min_s: float, max_s: float) -> np.ndarray:
    """The n quantiles (at (i + 0.5) / n) of a log-uniform distribution on
    [min_s, max_s], in samples, shortest first."""
    q = (np.arange(n) + 0.5) / n
    secs = np.exp(np.log(min_s) + q * (np.log(max_s) - np.log(min_s)))
    return np.floor(secs * SR).astype(np.int64)


def compose(n_samples: int, bank: Dict[str, np.ndarray], words: List[str],
            rng: np.random.Generator) -> Tuple[np.ndarray, str]:
    """One utterance of exactly n_samples: words with silence gaps added
    while the next one fits, the rest silence split at random between the
    start and the end."""
    parts, chosen, used = [], [], 0
    while True:
        w = words[int(rng.integers(len(words)))]
        gap = int(rng.integers(*GAP_SAMPLES)) if chosen else 0
        if used + gap + len(bank[w]) > n_samples:
            if chosen:
                break
            continue
        if gap:
            parts.append(np.zeros(gap, np.float32))
        parts.append(bank[w])
        chosen.append(w)
        used += gap + len(bank[w])
    lead = int(rng.integers(n_samples - used + 1))
    out = np.zeros(n_samples, np.float32)
    out[lead:lead + used] = np.concatenate(parts)
    return out, " ".join(chosen)


def utterances(seed: int, n: int, min_s: float, max_s: float,
               labels: Sequence[str]) -> Tuple[List[np.ndarray], List[str]]:
    """n utterances at the quantile lengths, in an order drawn from the
    seed, each with its transcript. Only words no longer than the shortest
    utterance are drawn, so that every utterance holds one."""
    rng = np.random.default_rng(seed)
    bank = word_bank(labels)
    lengths = quantile_lengths(n, min_s, max_s)[rng.permutation(n)]
    words = [w for w in sorted(bank) if len(bank[w]) <= lengths.min()]
    # one buffer holds every utterance (each a view of it), the noise floor
    # drawn into it at once: one large allocation, the same in every run
    audio = rng.standard_normal(int(lengths.sum()), dtype=np.float32)
    audio *= NOISE_STD
    sigs, texts, at = [], [], 0
    for m in lengths:
        sig, text = compose(int(m), bank, words, rng)
        view = audio[at:at + len(sig)]
        view += sig
        sigs.append(view)
        texts.append(text)
        at += len(sig)
    return sigs, texts
