"""vietasr_tpu_torch's long-form path against the JAX package's, on the CPU
in fp32:

- `chunk_spans`, `_longform_grid`, `receptive_field_frames` and
  `encoder_stride` exactly;
- the G.711 decode on the device (ops/g711.py) exactly, over all 256
  codes, against JAX's and the host codec's;
- the polyphase resampler (ops/resample.py) against JAX's
  `make_device_resampler` and `scipy.signal.resample_poly` within 1e-6;
- `long_form_log_probs` on a narrow model within 1e-4 of JAX's;
- `transcribe_long` / `transcribe_long_batch` texts equal to JAX's on the
  trained anchor at full width, for float32, int16, mu-law, A-law and
  8 kHz input, greedy and device beam, one span and several, the fused
  program and the grouped path; and one ~40 s `transcribe_long`.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

import vietasr_tpu.streaming as jax_streaming
from vietasr_tpu.audio.g711 import alaw_encode, ulaw_encode
from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.models import model_init
from vietasr_tpu.ops.g711 import alaw_decode_f32 as jax_alaw
from vietasr_tpu.ops.g711 import ulaw_decode_f32 as jax_ulaw
from vietasr_tpu.ops.resample import make_device_resampler as jax_resampler
from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch import streaming
from vietasr_tpu_torch.audio import g711 as host_g711
from vietasr_tpu_torch.config import load_config
from vietasr_tpu_torch.models.convert import load_anchor
from vietasr_tpu_torch.ops.g711 import (alaw_decode_f32, decode_wire,
                                        ulaw_decode_f32)
from vietasr_tpu_torch.ops.resample import make_device_resampler
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")
FP32 = dict(compute_dtype=None)
# long-form chunking of the text cases: 4 s chunks, 1 s overlaps (3 spans
# for 10 s of audio)
LF = dict(chunk_seconds=4.0, overlap_seconds=1.0)


@pytest.mark.parametrize("n,chunk,overlap", [
    (1000, 2000, 100), (2000, 2000, 100), (2001, 2000, 100),
    (10000, 2000, 300), (12345, 3200, 640), (240000 * 3 + 7, 240000, 32000)])
def test_chunk_spans_matches_jax(n, chunk, overlap):
    assert streaming.chunk_spans(n, chunk, overlap) \
        == jax_streaming.chunk_spans(n, chunk, overlap)


def test_chunk_spans_overlap_too_large():
    with pytest.raises(ValueError, match="overlap"):
        streaming.chunk_spans(5000, 1000, 500)


def _narrow_yaml(tmp_path):
    """QuartzNet with 4 narrow blocks (64 features, 91 classes)."""
    text = open(CONFIG, encoding="utf-8").read()
    head, rest = text.split("    jasper:\n")
    tail = rest[rest.index("\nlabels:"):]
    blocks = [
        "{filters: 48, repeat: 1, kernel: [11], stride: [2], dilation: [1], "
        "dropout: 0.0, residual: false, separable: true}",
        "{filters: 48, repeat: 2, kernel: [7], stride: [1], dilation: [1], "
        "dropout: 0.0, residual: true, separable: true}",
        "{filters: 64, repeat: 1, kernel: [9], stride: [1], dilation: [2], "
        "dropout: 0.0, residual: true, separable: true}",
        "{filters: 96, repeat: 1, kernel: [1], stride: [1], dilation: [1], "
        "dropout: 0.0, residual: false, separable: false}"]
    path = tmp_path / "narrow.yaml"
    path.write_text(head + "    jasper:\n" + "".join(
        f"        - {b}\n" for b in blocks) + tail, encoding="utf-8")
    return str(path)


def test_grid_and_receptive_field_match_jax(tmp_path):
    for path in (CONFIG, _narrow_yaml(tmp_path)):
        cfg, jcfg = load_config(path), jax_load_config(path)
        assert streaming.receptive_field_frames(cfg.encoder) \
            == jax_streaming.receptive_field_frames(jcfg.encoder)
        assert streaming.encoder_stride(cfg.encoder) \
            == jax_streaming.encoder_stride(jcfg.encoder)
        for secs in ((15.0, 2.0), (4.0, 1.0), (0.01, 0.001), (7.33, 0.77)):
            assert streaming._longform_grid(
                types.SimpleNamespace(cfg=cfg), *secs) \
                == jax_streaming._longform_grid(
                    types.SimpleNamespace(cfg=jcfg), *secs)


def test_g711_device_decode_is_exact():
    codes = np.arange(256, dtype=np.uint8)
    for dev_fn, jax_fn, host_fn, law in (
            (ulaw_decode_f32, jax_ulaw, host_g711.ulaw_decode, "ulaw"),
            (alaw_decode_f32, jax_alaw, host_g711.alaw_decode, "alaw")):
        got = dev_fn(torch.from_numpy(codes)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(jax_fn(codes)))
        np.testing.assert_array_equal(
            got, host_fn(codes).astype(np.float32) / 32768.0)
        np.testing.assert_array_equal(
            decode_wire(torch.from_numpy(codes), law).numpy(), got)
    pcm = np.arange(-32768, 32768, 7, dtype=np.int16)
    np.testing.assert_array_equal(
        decode_wire(torch.from_numpy(pcm)).numpy(),
        pcm.astype(np.float32) / 32768.0)
    with pytest.raises(ValueError, match="G.711"):
        decode_wire(torch.from_numpy(codes), "opus")


@pytest.mark.parametrize("orig,target", [
    (8000, 16000), (44100, 16000), (22050, 16000), (48000, 16000),
    (16000, 8000), (11025, 16000)])
def test_resampler_matches_jax_and_scipy(orig, target):
    rng = np.random.RandomState(orig % 97)
    x = (rng.randn(3, 4001) * 0.3).astype(np.float32)
    g = np.gcd(orig, target)
    want = np.stack([resample_poly(r, target // g, orig // g) for r in x])
    got = make_device_resampler(orig, target)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-6
    jgot = np.asarray(jax_resampler(orig, target)(x))
    assert np.abs(got - jgot).max() < 1e-6
    one = make_device_resampler(orig, target)(torch.from_numpy(x[0]))
    assert np.abs(one.numpy() - want[0]).max() < 1e-6   # 1-D input


def test_long_form_log_probs_narrow(tmp_path):
    path = _narrow_yaml(tmp_path)
    jcfg = jax_load_config(path)
    variables = jax.tree_util.tree_map(
        np.asarray, model_init(jax.random.PRNGKey(3), jcfg))
    port = Transcriber(path, variables=variables, device="cpu",
                       options=TranscriberOptions(max_batch=2, **FP32))
    ref = JaxTranscriber(path, variables=variables,
                         options=JaxOptions(max_batch=2, **FP32))
    rng = np.random.RandomState(1)
    sig = (rng.randn(16000 * 9 + 321) * 0.1).astype(np.float32)
    kw = dict(chunk_seconds=2.5, overlap_seconds=0.5)
    got, n = streaming.long_form_log_probs(port, sig, **kw)
    want, jn = jax_streaming.long_form_log_probs(ref, sig, **kw)
    assert n == jn and got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4
    dev, dn = streaming.long_form_log_probs(port, sig, device=True, **kw)
    assert torch.is_tensor(dev) and dn == n
    np.testing.assert_array_equal(dev.numpy(), got)


@pytest.fixture(scope="module")
def anchor():
    return load_anchor(ANCHOR)


@pytest.fixture(scope="module")
def pairs(anchor):
    """Port and JAX Transcribers on the anchor in fp32, per decoder."""
    out = {}
    for dec in ("greedy", "device_beam", "beam"):
        kw = dict(decoder=dec, beam_width=16, **FP32)
        out[dec] = (Transcriber(CONFIG, variables=anchor, device="cpu",
                                options=TranscriberOptions(**kw)),
                    JaxTranscriber(CONFIG, variables=anchor,
                                   options=JaxOptions(**kw)))
    return out


def _signal(seed, seconds, sr=16000):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * sr)) * 0.1).astype(np.float32)


def _formats(sig16, sig8):
    """(name, signal, signal_sr, signal_encoding) input variants."""
    i16 = (np.clip(sig16, -1, 1) * 32767).astype(np.int16)
    return {
        "float32": (sig16, None, None),
        "int16": (i16, None, None),
        "ulaw": (ulaw_encode(sig16), None, "ulaw"),
        "alaw": (alaw_encode(sig16), None, "alaw"),
        "float32_8k": (sig8, 8000, None),
        "int16_8k": ((np.clip(sig8, -1, 1) * 32767).astype(np.int16),
                     8000, None),
        "ulaw_8k": (ulaw_encode(sig8), 8000, "ulaw"),
    }


@pytest.mark.parametrize("seconds", [3.5, 10.3])
@pytest.mark.parametrize("fmt", ["float32", "int16", "ulaw", "alaw",
                                 "float32_8k", "int16_8k", "ulaw_8k"])
def test_transcribe_long_greedy_matches_jax(pairs, fmt, seconds):
    """One span (3.5 s < the 4 s chunk) and three spans, every format."""
    port, ref = pairs["greedy"]
    x, sr, enc = _formats(_signal(7, seconds), _signal(8, seconds / 2,
                                                       8000))[fmt]
    kw = dict(signal_sr=sr, signal_encoding=enc, **LF)
    got = port.transcribe_long(x, **kw)
    assert got == ref.transcribe_long(x, **kw)
    assert port.transcribe_long_batch([x], **kw) == [got]


@pytest.mark.parametrize("fmt", ["float32", "int16_8k", "ulaw"])
@pytest.mark.parametrize("decoder", ["device_beam", "beam"])
def test_transcribe_long_beams_match_jax(pairs, fmt, decoder):
    port, ref = pairs[decoder]
    x, sr, enc = _formats(_signal(9, 9.1), _signal(10, 4.4, 8000))[fmt]
    kw = dict(signal_sr=sr, signal_encoding=enc, **LF)
    got = port.transcribe_long(x, **kw)
    assert got == ref.transcribe_long(x, **kw)
    # non-greedy decoders take transcribe_long one by one
    assert port.transcribe_long_batch([x, x[: len(x) // 3]], **kw) \
        == [got, ref.transcribe_long(x[: len(x) // 3], **kw)]


def test_transcribe_long_batch_and_program_cache(pairs):
    port, ref = pairs["greedy"]
    sigs = [_signal(s, secs) for s, secs in ((1, 10.3), (2, 3.0),
                                             (3, 16.2), (4, 10.1))]
    got = port.transcribe_long_batch(sigs, **LF)
    assert got == ref.transcribe_long_batch(sigs, **LF)
    assert got == [port.transcribe_long(s, **LF) for s in sigs]
    # one program per (n_spans, chunk, overlap, want_lp, in_sr, in_dtype)
    assert set(port._longform_programs) == set(ref._longform_programs)


def test_grouped_path_matches_jax(pairs, monkeypatch):
    """Past FUSED_MAX_SPANS the grouped path (host conversion, max_batch
    chunks a forward) takes over, in both packages."""
    port, ref = pairs["greedy"]
    monkeypatch.setattr(streaming, "FUSED_MAX_SPANS", 2)
    monkeypatch.setattr(jax_streaming, "FUSED_MAX_SPANS", 2)
    x = ulaw_encode(_signal(5, 7.0, 8000))
    kw = dict(signal_sr=8000, signal_encoding="ulaw", **LF)
    assert port.transcribe_long(x, **kw) == ref.transcribe_long(x, **kw)
    with pytest.raises(ValueError, match="G.711"):
        port.transcribe_long(x, signal_sr=8000, **LF)


def test_uint8_needs_an_encoding(pairs):
    port, _ = pairs["greedy"]
    with pytest.raises(ValueError, match="G.711"):
        port.transcribe_long(ulaw_encode(_signal(6, 9.0)), **LF)


def test_transcribe_long_40s_full_width(pairs):
    """The default 15 s chunks and 2 s overlaps over ~40 s (3 spans)."""
    port, ref = pairs["greedy"]
    sig = _signal(40, 40.2)
    got = port.transcribe_long(sig)
    assert got and got == ref.transcribe_long(sig)
    pcm = (sig * 32767).astype(np.int16)
    assert port.transcribe_long(pcm) == ref.transcribe_long(pcm)
