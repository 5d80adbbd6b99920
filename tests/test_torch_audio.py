"""vietasr_tpu_torch.audio (io, g711, mp3) against the JAX package's copies
on the same files: WAVs written from a seeded signal (PCM16, PCM8, float32,
mu-law and A-law at 8, 16 and 44.1 kHz), read and resampled to 16 kHz,
equal exactly (the same numpy and scipy calls); trim_silence and resample
equal exactly; mp3 decodes (libmpg123, fixtures encoded with libmp3lame)
equal exactly, and skip where either library is absent."""

import numpy as np
import pytest
from scipy.io import wavfile
from test_g711 import _g711_wav_bytes
from test_mp3 import lame_encode

from vietasr_tpu.audio import g711 as jg711
from vietasr_tpu.audio import io as jio
from vietasr_tpu.audio import mp3 as jmp3
from vietasr_tpu_torch.audio import g711 as tg711
from vietasr_tpu_torch.audio import io as tio
from vietasr_tpu_torch.audio import mp3 as tmp3

RATES = [8000, 16000, 44100]
FORMATS = ["pcm16", "pcm8", "float32", "ulaw", "alaw"]


def _signal(sr, seconds=0.7, seed=0):
    """Seeded speech-like test audio: a tone burst over noise with quiet
    lead-in and tail, so that trim_silence has something to trim."""
    rng = np.random.RandomState(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    sig = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.randn(n)
    env = np.zeros(n)
    env[n // 5: 4 * n // 5] = 1.0
    return (sig * env + 1e-5 * rng.randn(n)).astype(np.float32)


def _write_wav(path, sig, sr, fmt):
    if fmt == "pcm16":
        wavfile.write(path, sr, (sig * 32767).astype(np.int16))
    elif fmt == "pcm8":
        wavfile.write(path, sr, (sig * 127 + 128).astype(np.uint8))
    elif fmt == "float32":
        wavfile.write(path, sr, sig)
    else:
        enc = tg711.ulaw_encode if fmt == "ulaw" else tg711.alaw_encode
        with open(path, "wb") as f:
            f.write(_g711_wav_bytes(enc(sig), sr, 7 if fmt == "ulaw" else 6))


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_read_audio_equals_jax(tmp_path, sr, fmt):
    path = str(tmp_path / f"clip_{fmt}.wav")
    _write_wav(path, _signal(sr), sr, fmt)
    for kw in ({}, {"target_sr": 16000}, {"target_sr": 16000, "trim": True},
               {"offset": 0.1, "duration": 0.3}):
        got, got_sr = tio.read_audio(path, **kw)
        want, want_sr = jio.read_audio(path, **kw)
        assert got_sr == want_sr
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), kw
    raw, raw_sr = tio.read_wav(open(path, "rb").read())   # bytes in
    assert raw_sr == sr and np.array_equal(raw, jio.read_wav(path)[0])


def test_g711_codecs_equal_jax():
    codes = np.arange(256, dtype=np.uint8)
    assert np.array_equal(tg711.ulaw_decode(codes), jg711.ulaw_decode(codes))
    assert np.array_equal(tg711.alaw_decode(codes), jg711.alaw_decode(codes))
    pcm = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    assert np.array_equal(tg711.ulaw_encode(pcm), jg711.ulaw_encode(pcm))
    assert np.array_equal(tg711.alaw_encode(pcm), jg711.alaw_encode(pcm))


@pytest.mark.parametrize("orig,target", [(8000, 16000), (44100, 16000),
                                         (16000, 8000), (22050, 16000),
                                         (16000, 16000)])
def test_resample_equals_jax(orig, target):
    sig = _signal(orig, seed=2)
    got, want = tio.resample(sig, orig, target), jio.resample(sig, orig,
                                                             target)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("top_db", [20.0, 40.0, 60.0])
def test_trim_silence_and_segment_equal_jax(top_db):
    sig = _signal(16000, seconds=1.3, seed=3)
    got = tio.trim_silence(sig, top_db=top_db)
    assert np.array_equal(got, jio.trim_silence(sig, top_db=top_db))
    assert 0 < len(got) < len(sig)
    assert len(tio.trim_silence(np.zeros(0, np.float32))) == 0
    seg, ref = tio.AudioSegment(sig, 16000), jio.AudioSegment(sig, 16000)
    for s in (seg, ref):
        s.gain_db(-6.0)
        s.pad(100, symmetric=True)
        s.subsegment(0.1, -0.2)
    assert np.array_equal(seg.samples, ref.samples)
    assert (seg.num_samples, seg.duration, seg.rms_db) == \
        (ref.num_samples, ref.duration, ref.rms_db)


def test_unsupported_wav_raises(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(_g711_wav_bytes(np.zeros(10, np.uint8), 8000, 0x55))
    with pytest.raises(ValueError):
        tio.read_audio(str(bad))


# -- mp3 (libmpg123), fixtures encoded with libmp3lame ------------------------

needs_mpg123 = pytest.mark.skipif(not tmp3.available(),
                                  reason="libmpg123 not on this system")


@needs_mpg123
@pytest.mark.parametrize("sr", RATES)
def test_mp3_decode_equals_jax(tmp_path, sr):
    blob = lame_encode(_signal(sr, seed=4), sr)
    got, got_sr = tmp3.decode_mp3(blob)
    want, want_sr = jmp3.decode_mp3(blob)
    assert got_sr == want_sr == sr and np.array_equal(got, want)
    path = tmp_path / "clip.mp3"
    path.write_bytes(blob)
    got, _ = tio.read_audio(str(path), target_sr=16000)
    assert np.array_equal(got, jio.read_audio(str(path),
                                              target_sr=16000)[0])
    junk = b"CALLLOG\x01\x02\x03" * 5               # no sync bytes
    assert tmp3.find_frame_sync(junk + blob) == \
        jmp3.find_frame_sync(junk + blob) > 0
    assert np.array_equal(tio.read_wav(junk + blob)[0],
                          jio.read_wav(junk + blob)[0])


@needs_mpg123
def test_mp3_faults_raise():
    with pytest.raises((ValueError, RuntimeError)):
        tmp3.decode_mp3(b"\xff\xfb" + b"\x00" * 64)
    rng = np.random.RandomState(5)
    a = lame_encode((0.2 * rng.randn(8000)).astype(np.float32), 16000)
    b = lame_encode((0.2 * rng.randn(4000)).astype(np.float32), 8000)
    with pytest.raises(ValueError, match="mid-stream"):
        tmp3.decode_mp3(a + b)
    assert tmp3.find_frame_sync(b"ab\xff\x1f" * 10) == -1
    assert tmp3.looks_like_mp3(b"ID3\x04") and not tmp3.looks_like_mp3(
        b"RIFF")
