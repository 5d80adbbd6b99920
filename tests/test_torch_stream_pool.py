"""vietasr_tpu_torch's streaming serving tier against the JAX package's, on
the CPU:

- `DeviceStreamingBeam.chunk`: the carried raw state equals JAX's over
  several chunks, with rows re-initialized by `reset_rows` mid-stream,
  without and with a word LM: transcript buffers, lengths, warm-up
  counters, best hypotheses and every hash and integer column of the
  packed state exactly, its float columns within 1e-6 relative (XLA's and
  PyTorch's CPU exp/log differ in the last bit, test_torch_device_beam);
  chunked texts equal the offline device beam's;
- `IncrementalGreedy` ids equal JAX's;
- `StreamPool`: every tick's wire pieces and every final text equal JAX's
  StreamPool on the same feed schedule (staggered streams, a mid-chunk
  true end, flushes, slot reuse), for each decoder ("greedy", "beam" with
  a word LM, "beam_host") and wire format (float32, int16, mu-law,
  A-law).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_streaming_online import small_models

from vietasr_tpu.audio.g711 import alaw_encode, ulaw_encode
from vietasr_tpu.ops.lm import load_lm as jax_load_lm
from vietasr_tpu.ops.lm import word_lm_tables as jax_word_lm_tables
from vietasr_tpu.ops.streaming_beam import \
    DeviceStreamingBeam as JaxStreamingBeam
from vietasr_tpu.serve.streams import IncrementalGreedy as JaxGreedy
from vietasr_tpu.serve.streams import StreamPool as JaxPool
from vietasr_tpu.streaming_online import OnlineTranscriber as JaxOnline
from vietasr_tpu_torch.ops.device_beam import (C_LM, C_PB, C_PNB,
                                               device_beam_transcripts,
                                               word_lm_to_device)
from vietasr_tpu_torch.ops.lm import load_lm, train_ngram_arpa, word_lm_tables
from vietasr_tpu_torch.ops.streaming_beam import DeviceStreamingBeam
from vietasr_tpu_torch.serve.streams import IncrementalGreedy, StreamPool
from vietasr_tpu_torch.streaming_online import OnlineTranscriber

torch.set_num_threads(1)

LABELS = ["a", "b", "c", " "]
BLANK = len(LABELS)
SPACE = LABELS.index(" ")
CORPUS = ["ab cab ba", "ab ba", "cab ab ba c", "ba cab", "c ab"] * 2
FLOAT_COLS = (C_PB, C_PNB, C_LM)


def _rand_lp(rng, bsz, t, v1, scale=2.0):
    logits = rng.randn(bsz, t, v1).astype(np.float32) * scale
    return np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))


@pytest.fixture(scope="module")
def word_lm(tmp_path_factory):
    arpa = str(tmp_path_factory.mktemp("lm") / "w.arpa")
    train_ngram_arpa(CORPUS, arpa, order=3, char_level=False)
    return arpa


def test_incremental_greedy_matches_jax():
    rng = np.random.RandomState(0)
    lp = rng.randn(41, 5).astype(np.float32)
    got = IncrementalGreedy(LABELS, blank=BLANK)
    want = JaxGreedy(LABELS, blank=BLANK)
    for i in range(0, 41, 7):
        assert got.feed(lp[i:i + 7]) == want.feed(lp[i:i + 7])
    assert got.ids == want.ids and got.text == want.text


@pytest.mark.parametrize("lm,skip,chunk", [(False, 0, 6), (True, 0, 9),
                                           (True, 7, 10)])
def test_device_streaming_beam_raw_matches_jax(word_lm, lm, skip, chunk):
    kw = dict(blank=BLANK, beam_width=16, space=SPACE, cutoff_top_n=3,
              alpha=0.5, beta=1.5, max_chars=64, skip_frames=skip)
    tables = None
    if lm:
        tables, probes = word_lm_tables(load_lm(word_lm), LABELS)
        kw["wlm_probes"] = probes
    jtables = None if not lm else jax_word_lm_tables(jax_load_lm(word_lm),
                                                     LABELS)[0]
    beam = DeviceStreamingBeam(
        word_lm=None if tables is None else word_lm_to_device(tables, "cpu"),
        device="cpu", **kw)
    jbeam = JaxStreamingBeam(word_lm=None if jtables is None else
                             jax.tree_util.tree_map(jnp.asarray, jtables),
                             **kw)
    rng = np.random.RandomState(7 + skip)
    bsz = 3
    carry, jcarry = beam.init(bsz), jbeam.init(bsz)
    for step in range(5):
        if step == 3:                  # a new stream on row 1 mid-stream
            mask = np.array([False, True, False])
            carry = beam.reset_rows(carry, torch.from_numpy(mask))
            jcarry = jbeam.reset_rows(jcarry, jnp.asarray(mask))
        lp = _rand_lp(rng, bsz, chunk, BLANK + 1)
        carry, ids, lens = beam.chunk(carry, torch.from_numpy(lp))
        jcarry, jids, jlens = jbeam.chunk(jcarry, jnp.asarray(lp))
        got, want = carry.st.numpy(), np.asarray(jcarry.st).view(np.int32)
        ints = [c for c in range(want.shape[-1]) if c not in FLOAT_COLS]
        np.testing.assert_array_equal(got[..., ints], want[..., ints])
        np.testing.assert_allclose(got[..., FLOAT_COLS].view(np.float32),
                                   want[..., FLOAT_COLS].view(np.float32),
                                   rtol=1e-6)
        for a, b in ((carry.buf, jcarry.buf), (carry.lens, jcarry.lens),
                     (carry.skip, jcarry.skip), (ids, jids), (lens, jlens)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("lm", [False, True])
def test_chunked_beam_equals_offline(word_lm, lm):
    """The carried search chunk by chunk == one offline search."""
    tables = None
    extra = {}
    if lm:
        tables, probes = word_lm_tables(load_lm(word_lm), LABELS)
        tables = word_lm_to_device(tables, "cpu")
        extra = dict(word_lm=tables, wlm_probes=probes)
    rng = np.random.RandomState(11)
    lp = _rand_lp(rng, 2, 36, BLANK + 1)
    beam = DeviceStreamingBeam(blank=BLANK, beam_width=16, space=SPACE,
                               cutoff_top_n=4, alpha=0.5, beta=1.5,
                               device="cpu", **extra)
    carry = beam.init(2)
    for i in range(0, 36, 8):
        carry, ids, lens = beam.chunk(carry, torch.from_numpy(lp[:, i:i + 8]))
    got = [beam.render(LABELS, ids[b].numpy(), int(lens[b])) for b in range(2)]
    want = device_beam_transcripts(
        torch.from_numpy(lp), torch.full((2,), 36), LABELS, beam_width=16,
        space=SPACE, cutoff_top_n=4, alpha=0.5, beta=1.5, **extra)
    assert got == want


def _schedule(rng, n_streams=3, chunk=3200):
    """Streams of 1.4-2.6 s opening at ticks 0, 1, 3: (start tick, padded
    chunks, true length)."""
    out = []
    for i, start in zip(range(n_streams), (0, 1, 3)):
        n = int(rng.uniform(1.4, 2.6) * 16000)
        sig = (rng.randn(n) * 0.1).astype(np.float32)
        pad = np.concatenate([sig, np.zeros((-n) % chunk, np.float32)])
        out.append((start, [pad[j:j + chunk]
                            for j in range(0, len(pad), chunk)], n))
    return out


def _wire(chunk, fmt):
    if fmt == "int16":
        return (np.clip(chunk, -1, 1) * 32767).astype(np.int16)
    if fmt == "ulaw":
        return ulaw_encode(chunk)
    if fmt == "alaw":
        return alaw_encode(chunk)
    return chunk


def _drive(pool, schedule, fmt):
    """Feed the schedule tick by tick (the stream's last chunk as the tail
    step at its true end), flush and close each stream when it ends, then
    reopen one slot for a second stream. Returns every tick's output and
    the final texts."""
    log, finals = [], []
    slots = {}
    n_ticks = max(s + len(c) for s, c, _ in schedule)
    for tick in range(n_ticks):
        for i, (start, _, _) in enumerate(schedule):
            if tick == start:
                slots[i] = pool.open()
        feed, tails, treal = {}, [], {}
        for i, (start, chunks, n) in enumerate(schedule):
            j = tick - start
            if 0 <= j < len(chunks):
                feed[slots[i]] = _wire(chunks[j], fmt)
                if j == len(chunks) - 1 and n % len(chunks[j]):
                    tails.append(slots[i])
                    treal[slots[i]] = n - j * len(chunks[j])
        log.append(pool.feed(feed, tail_slots=tuple(tails), tail_real=treal))
        for i, (start, chunks, n) in enumerate(schedule):
            if tick - start == len(chunks) - 1:
                log.append(pool.flush(slots[i], return_pieces=True,
                                      tail_done=bool(n % len(chunks[0]))))
                finals.append(pool.close(slots[i]))
    slot = pool.open()
    for c in schedule[0][1]:
        log.append(pool.feed({slot: _wire(c, fmt)}))
    log.append(pool.flush(slot, return_pieces=True))
    finals.append(pool.close(slot))
    return log, finals


@pytest.fixture(scope="module")
def streamers():
    jcfg, jvars, cfg, variables = small_models("causal_per_feature",
                                               labels=tuple(LABELS))
    return (OnlineTranscriber(cfg, variables, device="cpu"),
            JaxOnline(jcfg, jvars))


@pytest.mark.parametrize("decoder,fmt", [
    ("greedy", "float32"), ("greedy", "int16"), ("greedy", "ulaw"),
    ("greedy", "alaw"), ("beam", "ulaw"), ("beam", "float32"),
    ("beam_host", "int16")])
def test_stream_pool_matches_jax(streamers, word_lm, decoder, fmt):
    ot, jot = streamers
    kw = dict(slots=3, chunk_samples=3200, decoder=decoder, beam_width=8,
              lm_alpha=0.5, lm_beta=1.5,
              wire_encoding="alaw" if fmt == "alaw" else "ulaw",
              lm_path=word_lm if decoder != "greedy" else None)
    sched = _schedule(np.random.RandomState(len(decoder) + len(fmt)))
    got = _drive(StreamPool(ot, **kw), sched, fmt)
    want = _drive(JaxPool(jot, **kw), sched, fmt)
    assert got == want
    assert any(got[1])                    # the streams produced text


def test_stream_pool_contract(streamers):
    ot, _ = streamers
    pool = StreamPool(ot, slots=2, chunk_samples=3200)
    s1, s2 = pool.open(), pool.open()
    assert s1 != s2 and pool.open() is None
    with pytest.raises(ValueError, match="exactly"):
        pool.feed({s1: np.zeros(100, np.float32)})
    pool.close(s1)
    assert pool.open() is not None
    with pytest.raises(ValueError, match="wire_encoding"):
        StreamPool(ot, slots=1, wire_encoding="opus")
    with pytest.raises(ValueError, match="decoder"):
        StreamPool(ot, slots=1, decoder="viterbi")
    # mixed wire dtypes in one tick convert on the host
    pool = StreamPool(ot, slots=2, chunk_samples=3200)
    sa, sb = pool.open(), pool.open()
    rng = np.random.RandomState(1)
    pcm = (rng.randn(3200) * 3000).astype(np.int16)
    out = pool.feed({sa: pcm, sb: pcm.astype(np.float32) / 32768.0})
    assert set(out) == {sa, sb}
    np.testing.assert_array_equal(pool.states.audio[sa].numpy(),
                                  pool.states.audio[sb].numpy())
