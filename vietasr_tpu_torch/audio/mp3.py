"""MP3 decode via the system libmpg123 through ctypes (the port's copy of
vietasr_tpu/audio/mp3.py).

The reference decodes mp3 by shelling out to ffmpeg through
librosa/audioread (its segment.py:89-100 falls back to `librosa.load`,
and its infer.py:200 transcodes call-center mp3 with `ffmpeg -i`).
libmpg123, the standalone MPEG audio decoder, is a common system
library, so it is bound directly; where it is absent, decoding raises
NotImplementedError.

Decoding uses the feed API (mpg123_open_feed / mpg123_feed /
mpg123_read) so in-memory bytes (upload endpoints) and files take the
same path, with output forced to float32 so no fixed-point rescaling
is needed. MPEG-1/2/2.5 layers I-III at any rate/channel count come out
as (mono float32 in [-1, 1], sample_rate), matching read_wav's contract.

The tests build real fixtures by encoding with the system libmp3lame and
assert waveform-level round-trip fidelity.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_ENC_FLOAT_32 = 0x200
_MONO_OR_STEREO = 0x1 | 0x2
_MPEG_RATES = (8000, 11025, 12000, 16000, 22050, 24000,
               32000, 44100, 48000)

_lib: Optional[ctypes.CDLL] = None
_lib_err: Optional[str] = None


def _load() -> ctypes.CDLL:
    """Load + one-time-init libmpg123; cache the handle (or the failure)."""
    global _lib, _lib_err
    if _lib is not None:
        return _lib
    if _lib_err is not None:
        raise NotImplementedError(_lib_err)
    name = ctypes.util.find_library("mpg123")
    if name is None:
        _lib_err = ("mp3 decode needs libmpg123, which was not found on "
                    "this system; transcode to wav first")
        raise NotImplementedError(_lib_err)
    lib = ctypes.CDLL(name)
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_plain_strerror.restype = ctypes.c_char_p
    lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
    for fn, argtypes in (
            ("mpg123_open_feed", [ctypes.c_void_p]),
            ("mpg123_feed", [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_size_t]),
            ("mpg123_read", [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_size_t)]),
            ("mpg123_getformat", [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_long),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]),
            ("mpg123_format_none", [ctypes.c_void_p]),
            ("mpg123_format", [ctypes.c_void_p, ctypes.c_long,
                               ctypes.c_int, ctypes.c_int]),
            ("mpg123_close", [ctypes.c_void_p]),
            ("mpg123_delete", [ctypes.c_void_p]),
    ):
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        if fn in ("mpg123_delete",):
            f.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """True if libmpg123 is loadable on this system."""
    try:
        _load()
        return True
    except NotImplementedError:
        return False


def decode_mp3(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an in-memory mp3 -> (float32 mono waveform, sample_rate).

    Multi-channel audio is downmixed by mean, matching read_wav
    (io.py) and the reference AudioSegment (segment.py:57-58).
    """
    lib = _load()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError("mpg123_new failed: "
                           f"{lib.mpg123_plain_strerror(err.value)}")
    try:
        # Restrict output to float32 at every MPEG rate so mpg123 does
        # the fixed-point conversion and we read IEEE floats directly.
        lib.mpg123_format_none(h)
        for rate in _MPEG_RATES:
            lib.mpg123_format(h, rate, _MONO_OR_STEREO, _ENC_FLOAT_32)
        r = lib.mpg123_open_feed(h)
        if r != _MPG123_OK:
            raise RuntimeError("mpg123_open_feed failed: "
                               f"{lib.mpg123_plain_strerror(r)}")
        r = lib.mpg123_feed(h, data, len(data))
        if r != _MPG123_OK:
            raise RuntimeError("mpg123_feed failed: "
                               f"{lib.mpg123_plain_strerror(r)}")
        buf = (ctypes.c_ubyte * (1 << 17))()
        done = ctypes.c_size_t(0)
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        chunks = []
        while True:
            r = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(bytearray(buf[: done.value])))
            if r == _MPG123_NEW_FORMAT:
                prev = (rate.value, channels.value)
                lib.mpg123_getformat(h, ctypes.byref(rate),
                                     ctypes.byref(channels),
                                     ctypes.byref(enc))
                if prev != (0, 0) and prev != (rate.value, channels.value):
                    # concatenated streams with a mid-stream rate/channel
                    # change would silently mis-rate/mis-deinterleave the
                    # tail if chunks were just concatenated
                    raise ValueError(
                        f"mp3 stream changes format mid-stream "
                        f"({prev} -> {(rate.value, channels.value)}); "
                        "split the concatenated streams and decode "
                        "separately")
                continue
            if r in (_MPG123_DONE, _MPG123_NEED_MORE):
                break  # NEED_MORE == end of the fed bytes (feed API)
            if r != _MPG123_OK:
                raise RuntimeError("mpg123_read failed: "
                                   f"{lib.mpg123_plain_strerror(r)}")
        if not chunks or rate.value <= 0:
            raise ValueError("no decodable mpeg audio frames in input")
        samples = np.frombuffer(b"".join(chunks), np.float32)
        if channels.value > 1:
            n = len(samples) // channels.value * channels.value
            samples = samples[:n].reshape(-1, channels.value).mean(axis=1)
        return samples.astype(np.float32), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def find_frame_sync(blob: bytes, limit: int = 8192) -> int:
    """Offset of the first plausible MPEG frame header within the first
    `limit` bytes, or -1. Streams with leading junk (ad headers, partial
    RIFF wrappers — common in call-center dumps) still get a decode
    attempt; mpg123 resyncs past the junk itself."""
    window = blob[: limit + 1]
    pos = window.find(b"\xff")
    while 0 <= pos < limit:
        if looks_like_mp3(window[pos : pos + 4]):
            return pos
        pos = window.find(b"\xff", pos + 1)
    return -1


def looks_like_mp3(head: bytes) -> bool:
    """Sniff mp3 content: ID3v2 tag or an MPEG frame sync at offset 0.

    Extension-less uploads still decode correctly (the reference keys on
    filename only, infer.py:199)."""
    if head[:3] == b"ID3":
        return True
    if len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0:
        # frame sync; reject reserved layer/version bits
        version = (head[1] >> 3) & 0x3
        layer = (head[1] >> 1) & 0x3
        return version != 1 and layer != 0
    return False
