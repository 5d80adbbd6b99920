"""vietasr_tpu_torch's Transcriber on the reference's artifacts against the
JAX package's, at the full width of QuartzNet12x1_vi on the trained anchor,
on the CPU in fp32:

- `decoder="beam"` (the host C++ beam search, W = 100, alpha 0.5, beta 1.5)
  with a word 3-gram as ARPA, as a PROBING binary and as a TRIE binary:
  transcripts equal JAX's `Transcriber(decoder="beam")` on 4 short clips;
- built from the reference's two NeMo `.pt` files (written from the
  anchor): log-probs within 1e-4 of JAX's `Transcriber(encoder_checkpoint=,
  decoder_checkpoint=)` (fp32 sums in another order over 15 blocks), and
  equal bit for bit to the port's anchor Transcriber;
- no weights: a random init under a generator seeded 0, overlaid with the
  one `.pt` file given;
- `transcribe_file` of a PCM16 and an 8 kHz mu-law WAV equals `transcribe`
  of the samples `read_audio` returns, and JAX's `transcribe_file`; of a
  17 s WAV (past the last bucket) the port's `transcribe_long`, and JAX's
  `transcribe_file`;
- `decoder="device_beam"` from the PROBING binary equals the ARPA route.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile
from test_g711 import _g711_wav_bytes

from vietasr_tpu.models.convert import state_dict_from_variables
from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch.audio.g711 import ulaw_encode
from vietasr_tpu_torch.audio.io import read_audio
from vietasr_tpu_torch.models.convert import load_anchor, to_numpy
from vietasr_tpu_torch.ops.kenlm_binary import write_kenlm_binary
from vietasr_tpu_torch.ops.kenlm_trie import write_kenlm_trie
from vietasr_tpu_torch.ops.lm import train_ngram_arpa
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")
MANIFEST = os.path.join(ROOT, "artifacts", "real_speech_manifest.json")
VI_CORPUS = [
    "xin chào các bạn", "bản tin thời sự hôm nay", "chào mừng quý vị",
    "tin tức trong ngày", "cảm ơn các bạn đã lắng nghe",
    "thời tiết hà nội hôm nay", "chúc các bạn một ngày tốt lành",
    "đây là đài tiếng nói việt nam", "tin thể thao quốc tế",
    "giá xăng dầu trong nước", "tình hình giao thông buổi sáng",
    "xin kính chào quý vị và các bạn", "bản tin cuối ngày",
    "chương trình ca nhạc theo yêu cầu", "dự báo thời tiết ngày mai",
] * 2
FP32 = dict(compute_dtype=None)


@pytest.fixture(scope="module")
def anchor():
    return load_anchor(ANCHOR)


@pytest.fixture(scope="module")
def clips():
    """Four seeded clips of the 2 s bucket (one forward each side)."""
    rng = np.random.RandomState(0)
    return [(rng.randn(n) * 0.1).astype(np.float32)
            for n in (16000, 24000, 30400, 28000)]


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """The word 3-gram over the corpus and the manifest's transcripts as
    ARPA, PROBING binary and TRIE binary."""
    with open(MANIFEST, encoding="utf-8") as f:
        refs = [json.loads(line)["text"].strip() for line in f]
    d = tmp_path_factory.mktemp("lms")
    paths = {k: str(d / f"vi_word3.{k}") for k in ("arpa", "probing", "trie")}
    train_ngram_arpa(VI_CORPUS + refs, paths["arpa"], order=3)
    write_kenlm_binary(paths["arpa"], paths["probing"])
    write_kenlm_trie(paths["arpa"], paths["trie"])
    return paths


@pytest.fixture(scope="module")
def jax_beam(anchor, lms):
    return JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions(
        decoder="beam", lm_path=lms["arpa"], **FP32))


@pytest.mark.parametrize("kind", ["arpa", "probing", "trie"])
def test_host_beam_transcripts_equal_jax(anchor, clips, lms, jax_beam, kind):
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(
                           decoder="beam", lm_path=lms[kind], **FP32))
    assert port._decoder is not None and port._decoder._native is not None
    assert port.opts.beam_width == 100
    got = port.transcribe_batch(clips)
    if kind == "arpa":
        want = jax_beam.transcribe_batch(clips)
    else:
        want = JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions(
            decoder="beam", lm_path=lms[kind], **FP32)).transcribe_batch(clips)
    assert got == want
    assert all(isinstance(t, str) for t in got) and any(got)


def test_lm_path_with_greedy_means_host_beam(anchor, clips, lms, jax_beam):
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(lm_path=lms["arpa"],
                                                  **FP32))
    assert port._decoder is not None
    assert port.transcribe_batch(clips) == jax_beam.transcribe_batch(clips)


@pytest.fixture(scope="module")
def pt_files(anchor, tmp_path_factory):
    from vietasr_tpu_torch.config import load_config

    sd = state_dict_from_variables(anchor, load_config(CONFIG).encoder)
    d = tmp_path_factory.mktemp("pt")
    enc, dec = str(d / "JasperEncoder-STEP-0.pt"), \
        str(d / "JasperDecoderForCTC-STEP-0.pt")
    for path, prefix in ((enc, "encoder."), (dec, "decoder_layers.")):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items() if k.startswith(prefix)}, path)
    return enc, dec


def test_pt_checkpoints_log_probs_equal_jax(anchor, clips, pt_files):
    enc, dec = pt_files
    port = Transcriber(CONFIG, encoder_checkpoint=enc, decoder_checkpoint=dec,
                       device="cpu", options=TranscriberOptions(**FP32))
    jax_tr = JaxTranscriber(CONFIG, encoder_checkpoint=enc,
                            decoder_checkpoint=dec,
                            options=JaxOptions(**FP32))
    from_anchor = Transcriber(CONFIG, variables=anchor, device="cpu",
                              options=TranscriberOptions(**FP32))
    for clip in clips[:2]:
        got, got_lens = port.log_probs(clip)
        want, want_lens = jax_tr.log_probs(clip)
        np.testing.assert_array_equal(got_lens, want_lens)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
        same, _ = from_anchor.log_probs(clip)
        assert np.array_equal(got, same)


def test_random_init_and_one_checkpoint_overlay(anchor, clips, pt_files):
    enc, dec = pt_files
    opts = TranscriberOptions(fold_bn=False, **FP32)
    rand = Transcriber(CONFIG, device="cpu", options=opts)
    again = Transcriber(CONFIG, device="cpu", options=opts)
    lp, _ = rand.log_probs(clips[0])
    assert np.isfinite(lp).all() and np.array_equal(lp, again.log_probs(
        clips[0])[0])
    ref = to_numpy(Transcriber(CONFIG, variables=anchor, device="cpu",
                               options=opts).variables)
    init = to_numpy(rand.variables)
    enc_only = to_numpy(Transcriber(CONFIG, encoder_checkpoint=enc,
                                    device="cpu", options=opts).variables)
    dec_only = to_numpy(Transcriber(CONFIG, decoder_checkpoint=dec,
                                    device="cpu", options=opts).variables)

    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(map(equal, a, b))
        return np.array_equal(a, b)

    p = "params"
    assert equal(enc_only[p]["encoder"], ref[p]["encoder"])
    assert equal(enc_only["batch_stats"], ref["batch_stats"])
    assert equal(enc_only[p]["decoder"], init[p]["decoder"])
    assert equal(dec_only[p]["decoder"], ref[p]["decoder"])
    assert equal(dec_only[p]["encoder"], init[p]["encoder"])
    assert not equal(init[p]["decoder"], ref[p]["decoder"])


def test_transcribe_file_equals_transcribe(anchor, lms, jax_beam, tmp_path):
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(
                           decoder="beam", lm_path=lms["probing"], **FP32))
    rng = np.random.RandomState(3)
    pcm = str(tmp_path / "clip16k.wav")
    wavfile.write(pcm, 16000, (rng.randn(25000) * 0.1 * 32767)
                  .astype(np.int16))
    ulaw = str(tmp_path / "clip8k_ulaw.wav")
    codes = ulaw_encode((rng.randn(12000) * 0.1).astype(np.float32))
    with open(ulaw, "wb") as f:
        f.write(_g711_wav_bytes(codes, 8000, 7))         # tag 7: mu-law
    for path in (pcm, ulaw):
        samples, sr = read_audio(path, target_sr=16000)
        assert sr == 16000
        text = port.transcribe_file(path)
        assert text == port.transcribe(samples)
        assert text == jax_beam.transcribe_file(path)
    # past the last bucket: the long-form path, as in JAX
    long = str(tmp_path / "long.wav")
    wavfile.write(long, 16000, (rng.randn(17 * 16000) * 0.1 * 32767)
                  .astype(np.int16))
    samples, _ = read_audio(long, target_sr=16000)
    text = port.transcribe_file(long)
    assert text == port.transcribe_long(samples)
    assert text == jax_beam.transcribe_file(long)


def test_device_beam_from_binary_equals_arpa(anchor, clips, lms):
    kw = dict(decoder="device_beam", beam_width=16, **FP32)
    texts = {}
    for kind in ("arpa", "probing", "trie"):
        port = Transcriber(CONFIG, variables=anchor, device="cpu",
                           options=TranscriberOptions(lm_path=lms[kind],
                                                      **kw))
        assert port._device_word_lm is not None
        texts[kind] = port.transcribe_batch(clips)
    assert texts["probing"] == texts["arpa"] == texts["trie"]
    jax_tr = JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions(
        lm_path=lms["probing"], **kw))
    assert jax_tr.transcribe_batch(clips) == texts["probing"]


def test_log_probs_on_device(anchor, clips):
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(**FP32))
    lp, lens = port.log_probs(clips[0], as_numpy=False)
    assert torch.is_tensor(lp) and lp.device.type == "cpu"
    assert isinstance(lens, np.ndarray)
    want, want_lens = port.log_probs(clips[0])
    assert np.array_equal(lp.numpy(), want) and np.array_equal(lens,
                                                               want_lens)
