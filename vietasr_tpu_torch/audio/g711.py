"""G.711 mu-law / A-law codecs on the host, numpy (the port's copy of
vietasr_tpu/audio/g711.py).

Telephony audio (the reference's 8 kHz call-center domain) ships as 8-bit
G.711. audio/io.py reads mu-law/A-law WAV files (RIFF format tags 7 / 6)
with these decoders: the reference read them via libsndfile (its
segment.py:89-100), and scipy.io.wavfile rejects them.

Implemented from the ITU-T G.711 definition (segmented 8-bit companding,
BIAS 0x84, CLIP 8159 in the 14-bit domain); verified bit-exact against
the CPython `audioop` implementation over all 65536 / 256 values.
"""

from __future__ import annotations

import numpy as np

_ULAW_BIAS = 0x84          # 132 in the 16-bit-scaled decode domain
_ULAW_CLIP14 = 8159        # clip in the 14-bit encode domain


def _to_int16(x: np.ndarray) -> np.ndarray:
    if np.issubdtype(np.asarray(x).dtype, np.floating):
        return np.clip(np.asarray(x, np.float64) * 32768.0,
                       -32768, 32767).astype(np.int16)
    return np.asarray(x, np.int16)


def _segment(mag: np.ndarray, ends: tuple) -> np.ndarray:
    seg = np.zeros(mag.shape, np.int32)
    for end in ends:
        seg += (mag > end).astype(np.int32)
    return seg


def ulaw_encode(x: np.ndarray) -> np.ndarray:
    """int16 (or float32 in [-1, 1]) -> uint8 mu-law codes.

    14-bit-domain form of the G.711 segmented encoder (arithmetic >> 2
    first — floor rounding for negatives — then bias 33, segment search,
    mantissa truncation); bit-exact vs audioop.lin2ulaw."""
    pcm = _to_int16(x).astype(np.int32) >> 2               # 14-bit, floor
    mask = np.where(pcm < 0, 0x7F, 0xFF)
    mag = np.minimum(np.abs(pcm), _ULAW_CLIP14) + (_ULAW_BIAS >> 2)
    seg = _segment(mag, (0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF))
    uval = (seg << 4) | ((mag >> (seg + 1)) & 0x0F)
    uval = np.where(mag > 0x1FFF, 0x7F, uval)              # saturate
    return ((uval ^ mask) & 0xFF).astype(np.uint8)


def ulaw_decode(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> int16 (audioop-compatible scaling)."""
    u = (~np.asarray(u).astype(np.int32)) & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = (((mant << 3) + _ULAW_BIAS) << exp) - _ULAW_BIAS
    return np.where(sign != 0, -mag, mag).astype(np.int16)


def alaw_encode(x: np.ndarray) -> np.ndarray:
    """int16 (or float32 in [-1, 1]) -> uint8 A-law codes.

    13-bit-domain segmented encoder (arithmetic >> 3 first, negatives
    mapped -pcm - 1); bit-exact vs audioop.lin2alaw."""
    pcm = _to_int16(x).astype(np.int32) >> 3               # 13-bit, floor
    mask = np.where(pcm >= 0, 0xD5, 0x55)
    mag = np.where(pcm >= 0, pcm, -pcm - 1)
    seg = _segment(mag, (0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF))
    over = mag > 0xFFF
    low = mag >> 1                                          # segment 0
    high = (seg << 4) | ((mag >> seg) & 0x0F)
    aval = np.where(over, 0x7F, np.where(seg == 0, low, high))
    return ((aval ^ mask) & 0xFF).astype(np.uint8)


def alaw_decode(u: np.ndarray) -> np.ndarray:
    """uint8 A-law codes -> int16 (audioop-compatible scaling)."""
    u = np.asarray(u).astype(np.int32) ^ 0x55
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag0 = (mant << 4) + 8                       # segment 0
    magn = ((mant << 4) + 0x108) << (exp - 1)    # segments 1..7
    mag = np.where(exp == 0, mag0, magn)
    return np.where(sign != 0, mag, -mag).astype(np.int16)
