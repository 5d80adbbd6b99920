"""vietasr_tpu_torch's chunked-causal Conformer streaming
(streaming_conformer.py, StreamPool over it) against the JAX package's and
against the port's own offline forward, on the CPU in fp32:

- `ConformerStream` equal to the port's offline chunked `conformer_apply`
  (2e-4, the JAX package's streaming contract) and to JAX's
  `ConformerStream` on the same weights (1e-4), conv2d and stack
  subsampling, left 1 and 2, conv kernels 5 and 7;
- the offline chunked forward is causal at chunk granularity;
- restart reproduces a stream, the rows of one batched state are
  independent streams, bad configs and chunks raise;
- `ConformerOnlineTranscriber.stream` equal to JAX's (1e-4) with and
  without `true_samples`, and to the offline chunked forward of the frames
  the stream saw (2e-4); `skip_first_step` holds at junk_align =
  4 * chunk_size;
- a 3-slot `StreamPool` equal to the single stream, with staggered opens
  and a slot re-opened mid-pool; every tick's wire pieces and final texts
  equal JAX's StreamPool over the same schedule (true-length tails,
  flushes) for greedy, beam_host and the device beam;
- beam_host and the device beam (its plain search on the CPU) over a
  Conformer pool equal the same decoder on the single stream's log-probs;
- the JAX package's long-form fault on a Conformer: its stitched output
  has 900 frames where its own offline forward has 1,000; the port's
  long-form stitches on the 4x subsampling (1,000 frames) and equals
  JAX's Transcriber run on each of the same spans and stitched at stride
  4 here (1e-4), on the grouped and the fused path.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conformer import (jax_variables, make_cfgs,
                                  write_narrow_yaml)

from vietasr_tpu.frontend.features import make_featurizer as jax_featurizer
from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.serve.streams import StreamPool as JaxPool
from vietasr_tpu.streaming import long_form_log_probs as jax_long_form
from vietasr_tpu.streaming_conformer import \
    ConformerOnlineTranscriber as JaxOnline
from vietasr_tpu.streaming_conformer import ConformerStream as JaxStream
from vietasr_tpu_torch.models.conformer import conformer_apply
from vietasr_tpu_torch.models.convert import params_from_jax
from vietasr_tpu_torch.ops.beam_search import StreamingPrefixBeam
from vietasr_tpu_torch.ops.lm import NGramLM, train_ngram_arpa
from vietasr_tpu_torch.serve.streams import (IncrementalBeam,
                                             IncrementalGreedy, StreamPool)
from vietasr_tpu_torch.streaming_conformer import (
    ConformerOnlineTranscriber, ConformerStream)
from vietasr_tpu_torch.streaming_online import StreamingFeaturizer

torch.set_num_threads(1)

OFFLINE_TOL = 2e-4
JAX_TOL = 1e-4
ROW_TOL = 1e-5
LABELS = [" ", "a", "b", "c"]


def offline(cfg, variables, feats):
    """The port's offline forward of one (T, F) feature sequence."""
    lp, _ = conformer_apply(params_from_jax(variables, device="cpu"),
                            torch.from_numpy(feats[None]),
                            torch.tensor([feats.shape[0]]),
                            cfg=cfg.conformer)
    return lp[0].numpy()


def raw_cfgs(seed, chunk_size=4, left_chunks=2):
    """A narrow chunked Conformer over 16 unnormalized mels and its JAX
    weights."""
    jax_cfg, cfg = make_cfgs(chunk_size=chunk_size, left_chunks=left_chunks,
                             feat_over=dict(normalize="", pad_to=1))
    return jax_cfg, cfg, jax_variables(jax_cfg, seed=seed)


@pytest.mark.parametrize("left,k,mode", [(1, 7, "conv2d"), (2, 5, "conv2d"),
                                         (2, 7, "stack")])
def test_stream_matches_offline_and_jax(left, k, mode):
    jax_cfg, cfg = make_cfgs(chunk_size=4, left_chunks=left, conv_kernel=k,
                             subsampling_mode=mode)
    variables = jax_variables(jax_cfg, seed=k)
    feats = np.random.RandomState(k).randn(80, 16).astype(np.float32)
    stream = ConformerStream(cfg, variables, device="cpu")
    chunks = [feats[i * stream.t_in:(i + 1) * stream.t_in] for i in range(5)]
    got = stream.stream(chunks)
    want = offline(cfg, variables, feats)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= OFFLINE_TOL
    jgot = JaxStream(jax_cfg, jax.tree_util.tree_map(jnp.asarray, variables)
                     ).stream(chunks)
    assert np.abs(got - jgot).max() <= JAX_TOL


def test_offline_chunked_is_chunk_causal():
    """A change after a chunk boundary moves no earlier chunk's output."""
    jax_cfg, cfg = make_cfgs(chunk_size=4, left_chunks=1)
    variables = jax_variables(jax_cfg, seed=1)
    rng = np.random.RandomState(1)
    a = rng.randn(48, 16).astype(np.float32)          # 3 chunks of mel
    b = a.copy()
    b[32:] += rng.randn(16, 16).astype(np.float32)    # chunk 3 changes
    lp_a, lp_b = offline(cfg, variables, a), offline(cfg, variables, b)
    np.testing.assert_allclose(lp_a[:8], lp_b[:8], atol=1e-5)
    assert np.abs(lp_a[8:] - lp_b[8:]).max() > 1e-3


def test_restart_and_rows_are_independent_streams():
    jax_cfg, cfg = make_cfgs(chunk_size=4)
    variables = jax_variables(jax_cfg, seed=2)
    stream = ConformerStream(cfg, variables, device="cpu")
    rng = np.random.RandomState(2)
    x = [rng.randn(2, stream.t_in, 16).astype(np.float32) for _ in range(3)]
    alone = [stream.stream([c[r] for c in x]) for r in range(2)]
    np.testing.assert_array_equal(alone[0], stream.stream([c[0] for c in x]))
    state = stream.init_state(2)
    outs = []
    for c in x:
        state, lp = stream.step(state, torch.from_numpy(c))
        outs.append(lp.numpy())
    batched = np.concatenate(outs, 1)
    # equal to ROW_TOL: the products are blocked differently at B = 2
    for r in range(2):
        np.testing.assert_allclose(batched[r], alone[r], atol=ROW_TOL)
    # a row re-initialized mid-stream restarts alone
    fresh = stream.init_state(2)
    state = stream.init_state(2)
    state, _ = stream.step(state, torch.from_numpy(x[0]))
    state = fresh.where(torch.tensor([True, False]), state)
    state, lp = stream.step(state, torch.from_numpy(x[1]))
    np.testing.assert_allclose(lp[0].numpy(),
                               stream.stream([x[1][0]]), atol=ROW_TOL)
    np.testing.assert_allclose(lp[1].numpy(),
                               alone[1][4:8], atol=ROW_TOL)


def test_stream_rejects_bad_configs():
    jax_cfg, cfg = make_cfgs(chunk_size=0)
    with pytest.raises(ValueError, match="chunk"):
        ConformerStream(cfg, jax_variables(jax_cfg), device="cpu")
    jax_cfg, cfg = make_cfgs(chunk_size=4)
    stream = ConformerStream(cfg, jax_variables(jax_cfg), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        stream.stream([np.zeros((7, 16), np.float32)])
    qcfg = dataclasses.replace(cfg, architecture="quartznet")
    with pytest.raises(ValueError, match="conformer"):
        ConformerStream(qcfg, jax_variables(jax_cfg), device="cpu")
    ot = ConformerOnlineTranscriber(cfg, jax_variables(jax_cfg),
                                    device="cpu")
    with pytest.raises(ValueError, match="exactly"):
        ot.stream([np.zeros(100, np.float32)])


@pytest.fixture(scope="module")
def online():
    jax_cfg, cfg, variables = raw_cfgs(seed=3)
    ot = ConformerOnlineTranscriber(cfg, variables, causal_norm=False,
                                    device="cpu")
    jot = JaxOnline(jax_cfg, jax.tree_util.tree_map(jnp.asarray, variables),
                    causal_norm=False)
    return jax_cfg, cfg, variables, ot, jot


def test_skip_first_step_and_geometry(online):
    _, cfg, _, ot, jot = online
    assert ot.skip_first_step and jot.skip_first_step
    assert ot._sf.junk_frames == 4 * cfg.conformer.chunk_size
    assert ot.required_chunk_samples == jot.required_chunk_samples == 2560
    assert ot.prefix_frames == jot.prefix_frames == cfg.conformer.chunk_size
    assert ot.out_frames(2560) == jot.out_frames(2560) == 4


@pytest.mark.parametrize("true_len", [None, 5 * 2560 + 777, 4 * 2560])
def test_online_stream_matches_jax_and_offline(online, true_len):
    _, cfg, variables, ot, jot = online
    rng = np.random.RandomState(4)
    cs = ot.required_chunk_samples
    sig = (rng.randn(6 * cs) * 0.1).astype(np.float32)
    if true_len is not None:
        sig[true_len:] = 0.0
    chunks = [sig[i * cs:(i + 1) * cs] for i in range(6)]
    got = ot.stream(chunks, true_samples=true_len)
    want = jot.stream(chunks, true_samples=true_len)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= JAX_TOL
    if true_len is not None:
        assert len(got) == -(-(-(-true_len // 160)) // 4)
        return
    # the offline chunked forward of exactly the frames the stream saw
    sf = StreamingFeaturizer(cfg.featurizer, causal_norm=False,
                             junk_align=ot._sf.junk_frames, device="cpu")
    fields = sf.init_fields(1)
    x0 = torch.from_numpy(chunks[0])[None]
    fields = (sf.reflect_carry(x0),) + fields[1:]
    frames = []
    for c in chunks:
        fields, out = sf.step(fields, torch.from_numpy(c)[None])
        frames.append(out[0].numpy())
    window = np.concatenate(frames, 0)[ot._sf.junk_frames:]
    want = offline(cfg, variables, window)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= OFFLINE_TOL


def _signals(rng, cs, n_chunks=4):
    return [(rng.randn(n_chunks * cs) * 0.1).astype(np.float32)
            for _ in range(3)]


def test_pool_equals_single_stream(online):
    """Staggered opens (ticks 0, 1, 2) and slot 0's stream replaced by a
    fresh one mid-pool: each stream's ids equal its single-stream decode."""
    _, cfg, _, ot, _ = online
    pool = StreamPool(ot, slots=3, chunk_samples=999)   # overridden
    assert pool.chunk_samples == ot.required_chunk_samples
    cs = pool.chunk_samples
    sigs = _signals(np.random.RandomState(5), cs) + \
        _signals(np.random.RandomState(6), cs, 3)[:1]
    chunks = [[s[i * cs:(i + 1) * cs] for i in range(len(s) // cs)]
              for s in sigs]
    refs = []
    for c in chunks:
        ref = IncrementalGreedy(cfg.labels, cfg.num_classes)
        ref.feed(ot.stream(c))
        refs.append(ref.ids)
    slots = {}
    got = {}
    for tick in range(7):
        if tick < 3:
            slots[tick] = pool.open()
        if tick == 4:                     # stream 0 ends; stream 3 reopens
            got[0] = list(pool.decoders[slots[0]].ids)
            pool.close(slots[0])
            slots[3] = pool.open()
            assert slots[3] == slots[0]
        feed = {}
        for i, start in ((0, 0), (1, 1), (2, 2), (3, 4)):
            j = tick - start
            if i in slots and 0 <= j < len(chunks[i]) and (i != 0
                                                           or tick < 4):
                feed[slots[i]] = chunks[i][j]
        pool.feed(feed)
    for i in (1, 2, 3):
        got[i] = list(pool.decoders[slots[i]].ids)
    assert [got[i] for i in range(4)] == refs
    assert any(refs)


def _schedule(rng, cs):
    """Streams of 3-6 chunks opening at ticks 0, 1, 3, the last two ending
    inside a chunk: (start tick, padded chunks, true length)."""
    out = []
    for start, n_chunks, frac in ((0, 3, 0.0), (1, 5, 0.4), (3, 4, 0.7)):
        n = int((n_chunks - 1 + (frac or 1.0)) * cs)
        sig = (rng.randn(n) * 0.1).astype(np.float32)
        pad = np.concatenate([sig, np.zeros((-n) % cs, np.float32)])
        out.append((start, [pad[j:j + cs] for j in range(0, len(pad), cs)],
                    n))
    return out


def _drive(pool, schedule, cs):
    """Every tick's pieces and the final texts: the last chunk as the tail
    step at its true end, then the flush and close; a slot reopened for a
    last stream."""
    log, finals, slots = [], [], {}
    n_ticks = max(s + len(c) for s, c, _ in schedule)
    for tick in range(n_ticks):
        for i, (start, _, _) in enumerate(schedule):
            if tick == start:
                slots[i] = pool.open()
        feed, tails, treal = {}, [], {}
        for i, (start, chunks, n) in enumerate(schedule):
            j = tick - start
            if 0 <= j < len(chunks):
                feed[slots[i]] = chunks[j]
                if j == len(chunks) - 1 and n % cs:
                    tails.append(slots[i])
                    treal[slots[i]] = n - j * cs
        log.append(pool.feed(feed, tail_slots=tuple(tails), tail_real=treal))
        for i, (start, chunks, n) in enumerate(schedule):
            if tick - start == len(chunks) - 1:
                log.append(pool.flush(slots[i], return_pieces=True,
                                      tail_done=bool(n % cs)))
                finals.append(pool.close(slots[i]))
    slot = pool.open()
    for c in schedule[1][1]:
        log.append(pool.feed({slot: c}))
    log.append(pool.flush(slot, return_pieces=True))
    finals.append(pool.close(slot))
    return log, finals


@pytest.fixture(scope="module")
def word_lm(tmp_path_factory):
    arpa = str(tmp_path_factory.mktemp("lm") / "w.arpa")
    train_ngram_arpa(["a b a", "b a b", "a a b", "c a b", "b c"] * 3, arpa,
                     order=3, char_level=False)
    return arpa


@pytest.mark.parametrize("decoder", ["greedy", "beam_host", "beam"])
def test_pool_matches_jax_pool(online, word_lm, decoder):
    _, _, _, ot, jot = online
    kw = dict(slots=3, decoder=decoder, beam_width=6, lm_alpha=0.4,
              lm_beta=1.0, lm_path=None if decoder == "greedy" else word_lm)
    cs = ot.required_chunk_samples
    sched = _schedule(np.random.RandomState(len(decoder)), cs)
    got = _drive(StreamPool(ot, **kw), sched, cs)
    want = _drive(JaxPool(jot, **kw), sched, cs)
    assert got == want
    assert any(got[1])


def test_pool_beams_equal_single_stream_decode(online, word_lm):
    """beam_host and the device beam over the pool == the same decoder fed
    the single stream's log-probs (the device beam skipping the prefix
    frames, one chunk)."""
    _, cfg, _, ot, _ = online
    cs = ot.required_chunk_samples
    chunks = [(np.random.RandomState(9).randn(cs) * 0.1).astype(np.float32)
              for _ in range(5)]
    kw = dict(beam_width=6, lm_alpha=0.4, lm_beta=1.0)
    lp_all = ot.stream(chunks, drop_prefix=False)

    pool = StreamPool(ot, slots=2, decoder="beam_host", lm_path=word_lm,
                      **kw)
    s = pool.open()
    for c in chunks:
        pool.feed({s: c})
    ref = IncrementalBeam(cfg.labels, cfg.num_classes, beam_width=6,
                          lm=NGramLM(word_lm), alpha=0.4, beta=1.0)
    ref.feed(lp_all[ot.prefix_frames:])
    assert pool.decoders[s]._dec.best() == ref._dec.best()
    assert isinstance(pool.decoders[s]._dec, StreamingPrefixBeam)

    pool = StreamPool(ot, slots=2, decoder="beam", lm_path=word_lm, **kw)
    assert pool._dsb.skip_frames == ot.prefix_frames == 4
    s = pool.open()
    for c in chunks:
        pool.feed({s: c})
    beam = pool._dsb
    carry = beam.init(1)
    for i in range(0, len(lp_all), 4):
        carry, ids, lens = beam.chunk(carry, torch.from_numpy(
            lp_all[None, i:i + 4]))
    want = beam.render(cfg.labels, ids[0].numpy(), int(lens[0]))
    assert pool.close(s) == want


def test_jax_longform_reads_the_wrong_stride(tmp_path):
    """The JAX package's fault, recorded and not copied: its long-form
    takes the encoder stride from the Jasper blocks (1 for a Conformer,
    whose subsampling is 4x), so on a 1-block d = 32 stack Conformer over
    40 s with 15 s chunks and 1 s overlap it stitches 900 frames where its
    own offline forward has 1,000. The port stitches 1,000
    (test_conformer_longform_stitches_on_the_subsampling)."""
    yml = write_narrow_yaml(tmp_path / "c.yaml", num_blocks=1,
                            subsampling_mode="stack")
    jtr = JaxTranscriber(yml)
    sig = (np.random.RandomState(40).randn(40 * 16000) * 0.1) \
        .astype(np.float32)
    _, total = jax_long_form(jtr, sig, chunk_seconds=15.0,
                             overlap_seconds=1.0)
    lp, lens = jtr.log_probs(sig)
    assert int(np.asarray(lens)[0]) == math.ceil(40 * 100 / 4) == 1000
    assert total == 900
    # what the stitch should hold, for the record: the 4x-subsampled grid
    feats, flens = jax_featurizer(jtr.cfg.featurizer)(
        jnp.asarray(sig[None]), jnp.asarray([len(sig)]))
    assert int(np.asarray(flens)[0]) == 4000


@pytest.mark.parametrize("mode", ["conv2d", "stack"])
def test_conformer_longform_stitches_on_the_subsampling(tmp_path, mode):
    """40 s on a 1-block Conformer in 15 s spans with 1 s overlap: the
    port's stitched posterior has the offline forward's 1,000 frames, and
    equals JAX's Transcriber.log_probs run on each of the same spans (the
    rows the grouped path builds) and stitched here at stride 4; the fused
    program's posterior equals it too."""
    from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions
    from vietasr_tpu_torch.streaming import (_longform_grid, _prep_longform,
                                             _run_fused, chunk_spans,
                                             frame_stride,
                                             long_form_log_probs)

    yml = write_narrow_yaml(tmp_path / "c.yaml", num_blocks=1,
                            subsampling_mode=mode)
    jtr = JaxTranscriber(yml, options=JaxOptions(compute_dtype=None))
    variables = jax.tree_util.tree_map(np.asarray, jtr.variables)
    tr = Transcriber(yml, variables=variables, device="cpu",
                     options=TranscriberOptions(compute_dtype=None))
    assert frame_stride(tr.cfg) == 4
    sig = (np.random.RandomState(41).randn(40 * 16000) * 0.1) \
        .astype(np.float32)
    lp, total = long_form_log_probs(tr, sig, chunk_seconds=15.0,
                                    overlap_seconds=1.0)
    _, offline_lens = tr.log_probs(sig)
    assert total == int(offline_lens[0]) == 1000

    chunk, overlap, grid = _longform_grid(tr, 15.0, 1.0)
    assert grid == 160 * 4
    pieces = []
    for start, stop, keep_from, keep_to in chunk_spans(len(sig), chunk,
                                                       overlap):
        row = np.zeros((1, chunk), np.float32)
        row[0, : stop - start] = sig[start:stop]
        jlp, jlens = jtr.log_probs(row, lengths=np.array([stop - start]))
        f_from = math.ceil(keep_from / 160 / 4)
        f_to = min(int(np.asarray(jlens)[0]), math.ceil(keep_to / 160 / 4))
        pieces.append(np.asarray(jlp)[0, f_from:f_to])
    want = np.concatenate(pieces)
    assert want.shape[0] == 1000
    np.testing.assert_allclose(lp, want, atol=JAX_TOL, rtol=JAX_TOL)

    prep = _prep_longform(tr, sig, None, chunk, overlap)
    fused, fused_total = _run_fused(tr, prep, chunk, overlap, True)
    assert int(fused_total) == 1000
    np.testing.assert_allclose(fused[:1000].numpy(), want, atol=JAX_TOL,
                               rtol=JAX_TOL)
    assert isinstance(tr.transcribe_long(sig), str)
