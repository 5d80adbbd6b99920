"""vietasr_tpu_torch's featurizer normalizations and online streamer
against the JAX package's, on the CPU in fp32:

- the featurizer's `causal_per_feature`, `all_features` and frame splicing
  against JAX's `make_featurizer` on ragged batches, within 2e-4 (the
  plain frontend's bound, test_torch_frontend.py);
- `StreamingFeaturizer` (reflect carry, end-reflect tail, causal running
  stats) against JAX's: frames within 1e-4, carries within 1e-5 relative;
- `OnlineTranscriber.stream` against JAX's on the same chunks (plain,
  flush, true-length tail, prefix kept) within 1e-4, on a narrow model;
- the streamed log-probs against the port's own offline forward of the
  audio, within 1e-4 (the JAX package's contract); on the trained causal
  anchor at full width against an fp64 offline forward and JAX's stream,
  within twice the fp32 offline forward's own distance from fp64;
- the batched step: rows of one state advance as independent streams.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_streaming_online import small_model

from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeatCfg
from vietasr_tpu.frontend.features import make_featurizer as jax_featurizer
from vietasr_tpu.models.quartznet import fold_batchnorm as jax_fold
from vietasr_tpu.streaming_online import OnlineTranscriber as JaxOnline
from vietasr_tpu.streaming_online import \
    StreamingFeaturizer as JaxStreamingFeaturizer
from vietasr_tpu_torch.config import (BlockConfig, EncoderConfig,
                                      ModelConfig, SpecAugmentConfig,
                                      load_config)
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 make_featurizer)
from vietasr_tpu_torch.models.convert import load_anchor, params_from_jax
from vietasr_tpu_torch.models.quartznet import fold_batchnorm, quartznet_apply
from vietasr_tpu_torch.streaming_online import (OnlineTranscriber,
                                                StreamingFeaturizer)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUSAL_CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                             "quartznet12x1_vi_causal.yaml")
CAUSAL_ANCHOR = os.path.join(ROOT, "artifacts",
                             "real_speech_qn12x1_vi_causal.msgpack.gz")
FEAT_TOL = 2e-4
STREAM_TOL = 1e-4
CHUNK = 3200


def port_cfg(cfg) -> ModelConfig:
    """The port's ModelConfig of a JAX ModelConfig."""
    return ModelConfig(
        name=cfg.name, labels=list(cfg.labels),
        featurizer=FeaturizerConfig(**dataclasses.asdict(cfg.featurizer)),
        encoder=EncoderConfig(
            blocks=tuple(BlockConfig(**dataclasses.asdict(b))
                         for b in cfg.encoder.blocks),
            feat_in=cfg.encoder.feat_in),
        spec_augment=SpecAugmentConfig())


def small_models(normalize="", labels=("a", "b", "c")):
    """(JAX cfg, JAX folded variables, port cfg, numpy folded variables)
    of the JAX tests' narrow streaming model."""
    cfg, variables = small_model(normalize=normalize, labels=labels)
    return cfg, variables, port_cfg(cfg), jax.tree_util.tree_map(
        np.asarray, variables)


def port_offline(cfg, variables, signal):
    """The port's offline forward of one signal (fp32, plain ops)."""
    feats, flens = make_featurizer(cfg.featurizer, device="cpu")(
        torch.from_numpy(signal[None]),
        torch.tensor([len(signal)], dtype=torch.int32))
    lp, el = quartznet_apply(params_from_jax(variables, device="cpu"), feats,
                             flens, cfg=cfg.encoder)
    return lp[0, : int(el[0])].numpy()


def chunked(signal, chunk=CHUNK):
    pad = (-len(signal)) % chunk
    padded = np.concatenate([signal, np.zeros(pad, np.float32)])
    return [padded[i:i + chunk] for i in range(0, len(padded), chunk)]


@pytest.mark.parametrize("overrides", [
    {"normalize": "causal_per_feature"}, {"normalize": "all_features"},
    {"frame_splicing": 2}, {"frame_splicing": 3, "normalize": ""},
    {"frame_splicing": 2, "normalize": "causal_per_feature"},
    {"normalize": "all_features", "features": 80}])
def test_featurizer_modes_match_jax(overrides):
    """The whole featurizer. Causal stats over the first frames divide by
    std + 1e-2 of one or two frames, which amplifies the fp32 differences
    of the two DFT routes (~1e-6) up to 100x: those frames are held by
    test_normalize_matches_jax on equal inputs, the rest within 2e-4."""
    jcfg = JaxFeatCfg(dither=0.0, **overrides)
    cfg = FeaturizerConfig(dither=0.0, **overrides)
    rng = np.random.RandomState(len(str(overrides)))
    sig = (rng.randn(3, 40000) * 0.1).astype(np.float32)
    lens = np.array([40000, 23456, 8001], np.int32)
    want, want_len = jax_featurizer(jcfg)(jnp.asarray(sig), jnp.asarray(lens))
    got, got_len = make_featurizer(cfg, device="cpu")(torch.from_numpy(sig),
                                                      torch.from_numpy(lens))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    first = 16 if cfg.normalize == "causal_per_feature" else 0
    err = np.abs(got.numpy() - np.asarray(want))[:, first:]
    assert err.max() < FEAT_TOL


@pytest.mark.parametrize("normalize", ["per_feature", "causal_per_feature",
                                       "all_features", ""])
def test_normalize_matches_jax(normalize):
    """The normalizations alone, on the same log-mel input (ragged, one
    row of length 1 and one of 0)."""
    from vietasr_tpu.frontend.features import _normalize as jax_normalize
    from vietasr_tpu_torch.frontend.features import _normalize

    rng = np.random.RandomState(3)
    x = (rng.randn(4, 50, 64) * 3 - 8).astype(np.float32)
    seq = np.array([50, 17, 1, 0], np.int32)
    want = np.asarray(jax_normalize(jnp.asarray(x), jnp.asarray(seq),
                                    normalize))
    got = _normalize(torch.from_numpy(x), torch.from_numpy(seq),
                     normalize).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_unknown_normalize_raises():
    cfg = FeaturizerConfig(dither=0.0, normalize="bogus")
    with pytest.raises(ValueError, match="normalize"):
        make_featurizer(cfg, device="cpu")(torch.zeros(1, 16000),
                                           torch.tensor([16000]))


@pytest.mark.parametrize("causal", [True, False])
def test_streaming_featurizer_matches_jax(causal):
    jfc = JaxFeatCfg(dither=0.0)
    fc = FeaturizerConfig(dither=0.0)
    jsf = JaxStreamingFeaturizer(jfc, causal_norm=causal, junk_align=2)
    sf = StreamingFeaturizer(fc, causal_norm=causal, junk_align=2,
                             device="cpu")
    assert (sf.audio_carry, sf.junk_frames, sf.tail_valid_frames) == (
        jsf.audio_carry, jsf.junk_frames, jsf.tail_valid_frames)
    rng = np.random.RandomState(4)
    sig = (rng.randn(2, 5 * CHUNK) * 0.1).astype(np.float32)
    jcarry = np.stack([np.asarray(jsf.reflect_carry(jnp.asarray(s[:CHUNK])))
                       for s in sig])
    carry = sf.reflect_carry(torch.from_numpy(sig[:, :CHUNK]))
    # closed forms with factors p^-j up to ~2,400: fp32 relative rounding
    assert np.abs(carry.numpy() - jcarry).max() <= 1e-5 * np.abs(
        jcarry).max()
    jtail = np.stack([np.asarray(jsf.end_reflect_tail(jnp.asarray(c)))
                      for c in jcarry])
    assert np.abs(sf.end_reflect_tail(carry).numpy() - jtail).max() \
        <= 1e-5 * np.abs(jtail).max()
    fields = list(sf.init_fields(2))
    fields[0] = carry
    jfields = [list(jsf.init_fields()) for _ in range(2)]
    for r in range(2):
        jfields[r][0] = jnp.asarray(jcarry[r])
    # the log-mel of the two DFT routes differs by ~1e-5; causal stats of
    # the first three real frames divide by the std of at most three
    # frames (+ 1e-2), amplifying that up to 100x: those are left out
    first = sf.junk_frames + 3 if causal else 0
    for i in range(0, sig.shape[1], CHUNK):
        fields, out = sf.step(fields, torch.from_numpy(sig[:, i:i + CHUNK]))
        for r in range(2):
            jfields[r], jout = jsf.step(tuple(jfields[r]),
                                        jnp.asarray(sig[r, i:i + CHUNK]))
            err = np.abs(out[r].numpy() - np.asarray(jout))
            assert err[max(first - i // sf.fc.hop_length, 0):].max() < 1e-4
    for r in range(2):
        for got, want in zip(fields, jfields[r]):
            assert np.abs(got[r].numpy() - np.asarray(want)).max() \
                <= 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("normalize", ["", "causal_per_feature"])
@pytest.mark.parametrize("mode", ["plain", "flush", "true_samples",
                                  "keep_prefix"])
def test_stream_matches_jax(normalize, mode):
    jcfg, jvars, cfg, variables = small_models(normalize)
    causal = bool(normalize)
    jot = JaxOnline(jcfg, jvars, causal_norm=causal)
    ot = OnlineTranscriber(cfg, variables, causal_norm=causal, device="cpu")
    assert (ot.prefix_frames, ot.out_frames(CHUNK)) == (
        jot.prefix_frames, jot.out_frames(CHUNK))
    rng = np.random.RandomState(5)
    n_true = 2 * 16000 + 4487                   # ends mid-chunk, off-grid
    sig = (rng.randn(n_true) * 0.1).astype(np.float32)
    chunks = chunked(sig)
    kw = {"plain": {}, "flush": {"flush": True},
          "true_samples": {"true_samples": n_true},
          "keep_prefix": {"drop_prefix": False, "flush": True}}[mode]
    want = jot.stream(chunks, **kw)
    got = ot.stream(chunks, **kw)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < STREAM_TOL


@pytest.mark.parametrize("normalize,seconds", [("", 3.0),
                                               ("causal_per_feature", 2.0)])
def test_stream_matches_port_offline(normalize, seconds):
    """Streamed (flushed, prefix dropped) == the port's offline forward of
    the audio itself, chunk-aligned and with a mid-chunk true end."""
    _, _, cfg, variables = small_models(normalize)
    ot = OnlineTranscriber(cfg, variables, causal_norm=bool(normalize),
                           device="cpu")
    rng = np.random.RandomState(11)
    sig = (rng.randn(int(seconds * 16000)) * 0.1).astype(np.float32)
    for n, kw in ((len(sig), {"flush": True}),
                  (len(sig) - 1713, {"true_samples": len(sig) - 1713})):
        want = port_offline(cfg, variables, sig[:n])
        got = ot.stream(chunked(sig[:n]), **kw)
        m = min(len(got), len(want))
        assert m >= len(want) - 1
        assert np.abs(got[:m] - want[:m]).max() < STREAM_TOL


def test_batched_rows_are_independent_streams():
    """Two rows of one state, stepped together, equal each row streamed
    alone (the StreamPool's batch), including a tail on one row only."""
    _, _, cfg, variables = small_models("causal_per_feature")
    ot = OnlineTranscriber(cfg, variables, device="cpu")
    rng = np.random.RandomState(2)
    sigs = (rng.randn(2, 4 * CHUNK) * 0.1).astype(np.float32)
    st = ot.seed_carry(ot.init_state(2), torch.from_numpy(sigs[:, :CHUNK]))
    outs = []
    for i in range(0, 4 * CHUNK, CHUNK):
        last = i == 3 * CHUNK
        st, lp = ot.step(st, torch.from_numpy(sigs[:, i:i + CHUNK]),
                         is_tail=torch.tensor([last, False]),
                         tail_real=torch.tensor([1234 if last else 0, 0]))
        outs.append(lp.numpy())
    got = np.concatenate(outs, 1)
    for r in range(2):
        s1 = ot.seed_carry(ot.init_state(1),
                           torch.from_numpy(sigs[r:r + 1, :CHUNK]))
        want = []
        for i in range(0, 4 * CHUNK, CHUNK):
            last = r == 0 and i == 3 * CHUNK
            s1, lp = ot.step(s1, torch.from_numpy(sigs[r:r + 1, i:i + CHUNK]),
                             False, last, 1234 if last else 0)
            want.append(lp[0].numpy())
        np.testing.assert_array_equal(got[r], np.concatenate(want))


@pytest.fixture(scope="module")
def causal_anchor():
    """The trained causal anchor, folded, as numpy (port and JAX share)."""
    cfg = load_config(CAUSAL_CONFIG)
    jcfg = jax_load_config(CAUSAL_CONFIG)
    assert cfg.featurizer.normalize == jcfg.featurizer.normalize \
        == "causal_per_feature"
    variables = load_anchor(CAUSAL_ANCHOR)
    folded = fold_batchnorm(params_from_jax(variables, device="cpu"),
                            cfg.encoder)
    jfolded = jax_fold(jax.tree_util.tree_map(jnp.asarray, variables),
                       jcfg.encoder)
    return cfg, jcfg, folded, jfolded


def _offline(cfg, folded, signal, dtype):
    """The port's offline forward, every op in `dtype` (the plain
    featurizer's steps, then the per-op encoder)."""
    from vietasr_tpu_torch.frontend import features as F
    from vietasr_tpu_torch.models.quartznet import map_tree

    fc = cfg.featurizer
    dft = torch.from_numpy(F._windowed_dft_matrix(fc)).to(dtype)
    mel = torch.from_numpy(F._mel_matrix(fc)).to(dtype)
    xp = F.preemphasize_and_pad(torch.from_numpy(signal[None]).to(dtype), fc)
    spec = xp.unfold(1, fc.fft_length, fc.hop_length) @ dft
    nb = fc.fft_length // 2 + 1
    logmel = F.log_guard((spec[..., :nb] ** 2 + spec[..., nb:] ** 2) @ mel,
                         fc)
    flens = F.feature_seq_len(torch.tensor([len(signal)]), fc.hop_length)
    feats = F.mask_and_pad_time(F._normalize(logmel, flens, fc.normalize),
                                flens, logmel.shape[1], fc)
    lp, el = quartznet_apply(map_tree(lambda a: a.to(dtype), folded), feats,
                             flens, cfg=cfg.encoder)
    return lp[0, : int(el[0])].double().numpy()


def _dist(a, b):
    """(max |d p|, max |d log p|) over the common frames."""
    m = min(len(a), len(b))
    return np.array([np.abs(np.exp(a[:m]) - np.exp(b[:m])).max(),
                     np.abs(a[:m] - b[:m]).max()])


def test_causal_anchor_stream_full_width(causal_anchor):
    """QuartzNet12x1_vi trained with causal stats, 3200-sample chunks and
    a mid-chunk end. At full width the causal stats of the first frames
    divide by the std of a few frames (+ 1e-2), so how far an fp32 forward
    lies from an exact one depends on the signal: the stream is held
    against the fp64 offline forward, and against JAX's stream, at twice
    the fp32 offline forward's own distance from fp64, in p and in
    log p."""
    cfg, jcfg, folded, jfolded = causal_anchor
    ot = OnlineTranscriber(cfg, folded, device="cpu")
    jot = JaxOnline(jcfg, jfolded)
    rng = np.random.RandomState(20)
    n = 3 * 16000 + 1111
    sig = (rng.randn(n) * 0.1).astype(np.float32)
    got = ot.stream(chunked(sig), true_samples=n)
    want64 = _offline(cfg, folded, sig, torch.float64)
    off32 = _dist(_offline(cfg, folded, sig, torch.float32), want64)
    assert len(want64) - 1 <= len(got)
    assert np.all(_dist(got, want64) <= 2 * off32)
    jgot = jot.stream(chunked(sig), true_samples=n)
    assert jgot.shape == got.shape
    assert np.all(_dist(got, jgot) <= 2 * off32)
