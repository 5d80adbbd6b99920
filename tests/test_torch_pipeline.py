"""vietasr_tpu_torch Transcriber vs the JAX package's, at the full width
of QuartzNet12x1_vi on the trained anchor weights, on the CPU.

Three seeded clips in two duration buckets go through both in fp32: log
probabilities within 1e-4 (fp32 sums in another order over 15 blocks;
measured ~3e-5), encoded lengths and transcripts equal, for the greedy
decoder and for the device beam with a word 3-gram and a char 3-gram.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch.models.convert import load_anchor
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")
MANIFEST = os.path.join(ROOT, "artifacts", "real_speech_manifest.json")
# a small Vietnamese corpus for the test LMs (every char in the labels)
VI_CORPUS = [
    "xin chào các bạn", "bản tin thời sự hôm nay", "chào mừng quý vị",
    "tin tức trong ngày", "cảm ơn các bạn đã lắng nghe",
    "thời tiết hà nội hôm nay", "chúc các bạn một ngày tốt lành",
    "đây là đài tiếng nói việt nam", "tin thể thao quốc tế",
    "giá xăng dầu trong nước", "tình hình giao thông buổi sáng",
    "xin kính chào quý vị và các bạn", "bản tin cuối ngày",
    "chương trình ca nhạc theo yêu cầu", "dự báo thời tiết ngày mai",
] * 2


@pytest.fixture(scope="module")
def anchor():
    return load_anchor(ANCHOR)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.RandomState(0)
    # 1.5 s and 1.9 s share the 2 s bucket; 3.1 s goes to the 4 s bucket
    return [(rng.randn(n) * 0.1).astype(np.float32)
            for n in (24000, 30400, 49600)]


@pytest.fixture(scope="module")
def pair(anchor):
    jax_tr = JaxTranscriber(CONFIG, variables=anchor,
                            options=JaxOptions(compute_dtype=None))
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(compute_dtype=None))
    return jax_tr, port


def test_load_anchor_matches_flax(anchor):
    import flax.serialization

    with gzip.open(ANCHOR, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())

    def check(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys()
            for k in b:
                check(a[k], b[k])
        elif isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b)
            for x, y in zip(a, b):
                check(x, y)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    check(anchor, want)


def test_transcripts_equal_jax(pair, clips):
    jax_tr, port = pair
    want = jax_tr.transcribe_batch(clips)
    got = port.transcribe_batch(clips)
    assert got == want
    assert all(isinstance(t, str) for t in got)


def test_log_probs_match_jax(pair, clips):
    jax_tr, port = pair
    for clip in clips:
        want, want_lens = jax_tr.log_probs(clip)
        got, got_lens = port.log_probs(clip)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got_lens, want_lens)
        assert np.abs(got - want).max() <= 1e-4


def test_batched_rows_match_single(pair, clips):
    """Batching a short clip beside a long one leaves the long one's
    log-probs as they are alone (masking)."""
    _, port = pair
    long, short = clips[1], clips[0]
    batch = np.zeros((2, len(long)), np.float32)
    batch[0], batch[1, :len(short)] = long, short
    lp, lens = port.log_probs(batch, lengths=[len(long), len(short)])
    alone, alone_lens = port.log_probs(long)
    assert lens[0] == alone_lens[0]
    assert np.abs(lp[0, :lens[0]] - alone[0, :lens[0]]).max() <= 1e-4


def test_bf16_kernel_route_runs(anchor, pair, clips):
    """The default bf16 options (kernel route; its plain version on the
    CPU) stay near fp32: measured max |d log p| ~0.11 over 15 blocks of
    bf16 operands, bound 0.5; lengths equal."""
    _, port32 = pair
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(fused_frontend="on"))
    for clip in clips:
        lp, lens = port.log_probs(clip)
        ref, ref_lens = port32.log_probs(clip)
        assert np.isfinite(lp).all()
        np.testing.assert_array_equal(lens, ref_lens)
        assert np.abs(lp - ref).max() <= 0.5


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """A word 3-gram over the corpus and the manifest's transcripts, and a
    char 3-gram over the corpus (ARPA, written by the port)."""
    from vietasr_tpu_torch.ops.lm import train_ngram_arpa

    with open(MANIFEST, encoding="utf-8") as f:
        refs = [json.loads(line)["text"].strip() for line in f]
    d = tmp_path_factory.mktemp("lms")
    word, char = str(d / "vi_word3.arpa"), str(d / "vi_char3.arpa")
    train_ngram_arpa(VI_CORPUS + refs, word, order=3)
    train_ngram_arpa(VI_CORPUS, char, order=3, char_level=True)
    return {"word": word, "char": char}


@pytest.mark.parametrize("kind,width", [("word", 16), ("char", 8)])
def test_device_beam_transcripts_equal_jax(anchor, clips, lm_files, kind,
                                           width):
    """decoder="device_beam": the word LM takes the kernel route (its
    plain version on the CPU), the char LM the plain search."""
    kw = dict(decoder="device_beam", lm_path=lm_files[kind],
              beam_width=width, compute_dtype=None)
    jax_tr = JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions(**kw))
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(**kw))
    assert (port._device_word_lm is not None) == (kind == "word")
    assert (port._device_lm_table is not None) == (kind == "char")
    want = jax_tr.transcribe_batch(clips)
    got = port.transcribe_batch(clips)
    assert got == want
    assert all(isinstance(t, str) and "  " not in t for t in got)


@pytest.fixture(scope="module")
def mixed_clips():
    """Six clips over the 2, 4 and 6 s buckets; with max_batch=2 the 2 s
    bucket's three clips take two forwards."""
    rng = np.random.RandomState(1)
    return [(rng.randn(n) * 0.1).astype(np.float32)
            for n in (20000, 52000, 16000, 88000, 27000, 60000)]


BEAM_SPLIT = dict(decoder="device_beam", beam_width=16, compute_dtype=None,
                  max_batch=2)


def test_device_beam_one_decode_equals_jax(anchor, mixed_clips, lm_files):
    """The port decodes every row of a call in one beam search over log-probs
    padded to the longest T; JAX decodes each forward on its own. Rows are
    independent, so the texts, rendered in input order, are equal."""
    kw = dict(BEAM_SPLIT, lm_path=lm_files["word"])
    jax_tr = JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions(**kw))
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(**kw))
    want = jax_tr.transcribe_batch(mixed_clips)
    got = port.transcribe_batch(mixed_clips)
    assert got == want
    assert len(set(got)) > 1


def test_device_beam_decodes_once_per_call(anchor, mixed_clips, lm_files,
                                           monkeypatch):
    """transcribe_batch calls fused_beam_search once per call, on every row
    (the length-sorted forwards' rows, padded to the longest T), and renders
    each row's text at its signal's place."""
    from vietasr_tpu_torch.ops import fused_beam

    calls = []

    def spy(log_probs, lengths, **kw):
        calls.append((tuple(log_probs.shape), lengths.tolist()))
        n = log_probs.shape[0]
        # row b decodes to label b + 1 ('a', 'b', ...): texts show the row
        ids = torch.arange(1, n + 1, dtype=torch.int32)[:, None]
        return ids, torch.ones(n, dtype=torch.int32)

    monkeypatch.setattr(fused_beam, "fused_beam_search", spy)
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(lm_path=lm_files["word"],
                                                  **BEAM_SPLIT))
    order = sorted(range(len(mixed_clips)), key=lambda i: len(mixed_clips[i]))
    frames = [int(port.log_probs(mixed_clips[i])[1][0]) for i in order]
    labels = port.cfg.labels
    for n_calls in (1, 2):
        texts = port.transcribe_batch(mixed_clips)
        assert len(calls) == n_calls
        shape, lens = calls[-1]
        assert shape[0] == len(mixed_clips) and lens == frames
        assert shape[1] == port.log_probs(mixed_clips[order[-1]])[0].shape[1]
        assert texts == [labels[order.index(i) + 1]
                         for i in range(len(mixed_clips))]


def test_device_beam_caps_rows_per_decode(anchor, lm_files, monkeypatch):
    """A call decodes at most 4 x max_batch rows per beam search, and audio
    past the last bucket on its own, so the padded log-probs a search holds
    stay bounded however many signals a call has. Rows keep their texts'
    places."""
    from vietasr_tpu_torch.ops import fused_beam

    calls = []

    def spy(log_probs, lengths, **kw):
        n = log_probs.shape[0]
        first = sum(len(c[1]) for c in calls)
        calls.append((log_probs.shape[1], lengths.tolist()))
        # the k-th row decoded over the call renders as label k + 1
        ids = torch.arange(first + 1, first + n + 1, dtype=torch.int32)
        return ids[:, None], torch.ones(n, dtype=torch.int32)

    monkeypatch.setattr(fused_beam, "fused_beam_search", spy)
    opts = dict(BEAM_SPLIT, max_batch=1, buckets_seconds=(2.0, 4.0))
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(lm_path=lm_files["word"],
                                                  **opts))
    # four clips of the 2 s bucket, two of the 4 s one, one past it (5 s)
    sizes = (60000, 20000, 72000, 16000, 30000, 52000, 27000)
    rng = np.random.RandomState(2)
    sigs = [(rng.randn(n) * 0.1).astype(np.float32) for n in sizes]
    texts = port.transcribe_batch(sigs)
    assert [len(lens) for _, lens in calls] == [4, 2, 1]
    frames = [port.log_probs(sigs[sizes.index(n)])[0].shape[1]
              for n in (30000, 60000, 72000)]
    assert [t for t, _ in calls] == frames
    labels = port.cfg.labels
    ranks = sorted(range(len(sizes)), key=lambda i: sizes[i])
    assert texts == [labels[ranks.index(i) + 1] for i in range(len(sizes))]


def test_options_not_ported_raise(anchor, tmp_path):
    """What the port still refuses (`block_impl="pallas"`, an unknown
    decoder) raises; what it now takes (the host beam decoder, an LM path
    with the greedy decoder, a KenLM binary for the device beam, no
    weights at all, `fused_frontend="fast"`) constructs."""
    from vietasr_tpu.ops.kenlm_binary import write_kenlm_binary
    from vietasr_tpu_torch.ops.lm import train_ngram_arpa

    arpa, binary = str(tmp_path / "lm.arpa"), str(tmp_path / "lm.binary")
    train_ngram_arpa(VI_CORPUS, arpa, order=3)
    write_kenlm_binary(arpa, binary)
    for opts, err in ((TranscriberOptions(block_impl="pallas"), ValueError),
                      (TranscriberOptions(decoder="nope"), ValueError)):
        with pytest.raises(err):
            Transcriber(CONFIG, variables=anchor, device="cpu", options=opts)
    for opts in (TranscriberOptions(decoder="beam"),
                 TranscriberOptions(decoder="beam", lm_path=binary),
                 TranscriberOptions(lm_path=arpa),
                 TranscriberOptions(decoder="device_beam", lm_path=binary)):
        port = Transcriber(CONFIG, variables=anchor, device="cpu",
                           options=opts)
        assert (port._decoder is not None) == (opts.decoder != "device_beam")
        assert (port._device_word_lm is not None) == \
            (opts.decoder == "device_beam")
    assert Transcriber(CONFIG, device="cpu").variables["params"]["decoder"][
        "w"].shape == (1024, 91)
    fast = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(fused_frontend="fast"))
    assert fast._featurize.keywords["precision"] == "default"


def test_default_device_is_cuda(anchor):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Transcriber(CONFIG, variables=anchor)
