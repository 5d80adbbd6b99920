"""vietasr_tpu_torch's bf16 log-mel route (precision="default", the
pipeline's fused_frontend="fast") vs the JAX package, on the CPU.

On the CPU the route runs the bf16 kernel's plain version,
`log_mel_tiles_fast_plain`: the TPU kernel's precision="default" rounding
points (signal, windowed DFT matrix, power and mel matrix each rounded to
bf16 once, fp32 sums). Tolerances, with the values measured when they
were set:
- plain vs a numpy emulation built from the JAX package's own
  `_windowed_dft_matrix` and `mel_filterbank`, rounded to bf16 and summed
  in fp64, in the mel-power domain relative to each frame's largest mel
  power: max <= 2^-7, what one power term's bf16 rounding flipping under
  another summation order can move a mel (measured <= 9.1e-4), and the
  99.9th percentile <= 1e-6 (fp32 vs fp64 sums; measured <= 7.9e-8). The
  same bars hold an fp64 emulation of the CUDA kernel's own operands
  (`fast_tables`: the strided frame rows from k_lo, the interleaved
  (re, im) columns, the transposed mel matrix).
- the fast featurizer vs JAX fused_log_mel_features(interpret=True,
  precision="default"), which computes in fp32 on the CPU: seq_len equal;
  over the valid frames p99 |d| <= 0.2 and max |d| <= 2.0, the bf16 class
  (docs/rooflines.md: p99 0.13, max 1.41 on white noise; measured p99
  <= 0.146, max <= 1.04); and median |d| > 2e-4, the fp32 route's own
  tolerance: "fast" is the bf16 function, not the fp32 one renamed
  (measured median 4.1e-3).
- Transcriber(fused_frontend="fast", device="cpu") vs JAX's default
  Transcriber on the anchor: frame argmax agreement >= 0.95 (measured
  >= 0.98).
"""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeatCfg
from vietasr_tpu.frontend.features import \
    _windowed_dft_matrix as jax_windowed_dft
from vietasr_tpu.frontend.mel import mel_filterbank as jax_mel_filterbank
from vietasr_tpu.frontend.pallas_frontend import \
    fused_log_mel_features as jax_fused
from vietasr_tpu_torch.frontend.cuda_frontend import (
    FAST_BINS, FRAMES_PER_TILE, fast_mel_power_plain, fast_rows,
    fast_tables, fused_log_mel_features, fused_log_mel_features_plain,
    log_mel_tiles_fast_plain, make_fused_featurizer, tile_partials)
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix, _window_full,
                                                 _windowed_dft_matrix,
                                                 feature_seq_len,
                                                 preemphasize_and_pad)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")

FLIP_TOL = 2.0 ** -7       # one bf16 rounding step of a power term
SUM_TOL = 1e-6             # 99.9th percentile: fp32 vs fp64 sums
P99_TOL, MAX_TOL = 0.2, 2.0
FP32_TOL = 2e-4

# (config overrides, batch, seconds, seed): the vi config, ragged lengths
# mid-tile, 80 mels, a clip shorter than one 64-frame tile, the clamp guard
CASES = [({}, 2, 2.0, 0), ({}, 3, 3.7, 1), ({"features": 80}, 2, 1.3, 2),
         ({}, 2, 0.6, 3), ({"log_zero_guard_type": "clamp"}, 2, 2.0, 4)]


def _audio(bsz, seconds, seed, sr=16000):
    rng = np.random.RandomState(seed)
    sig = (rng.randn(bsz, int(seconds * sr)) * 0.1).astype(np.float32)
    lens = rng.randint(sr // 2, sig.shape[1] + 1, size=(bsz,)).astype(np.int32)
    return sig, lens


def _bf16(a) -> np.ndarray:
    """fp32 -> bf16 (round to nearest even) -> fp64."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float64)


def _numpy_padded(sig, cfg):
    x = np.concatenate([sig[:, :1], sig[:, 1:] - np.float32(cfg.preemph)
                        * sig[:, :-1]], axis=1).astype(np.float32)
    pad = cfg.fft_length // 2
    return np.pad(x, ((0, 0), (pad, pad)), mode="reflect")


def _frames(xp, cfg):
    t_out = (xp.shape[1] - cfg.fft_length) // cfg.hop_length + 1
    return xp[:, np.arange(t_out)[:, None] * cfg.hop_length
              + np.arange(cfg.fft_length)[None, :]]


def _emulated_mel_power(sig, jcfg, cfg):
    """The precision="default" chain in numpy from the JAX package's
    matrices: bf16 operands, fp64 sums, the power rounded to bf16."""
    n_bins = cfg.fft_length // 2 + 1
    spec = _bf16(_frames(_numpy_padded(sig, cfg), cfg)) \
        @ _bf16(jax_windowed_dft(jcfg))
    power = _bf16(spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2)
    mel = jax_mel_filterbank(cfg.sample_rate, cfg.fft_length, cfg.features,
                             cfg.lowfreq, cfg.highfreq)       # (n_mels, nb)
    return power @ _bf16(np.asarray(mel).T)


def _hold(got, want):
    """got vs want (B, T, n_mels) mel power, relative to each frame's
    largest mel power: (max, 99.9th percentile)."""
    rel = np.abs(np.asarray(got, np.float64) - want) \
        / want.max(-1, keepdims=True)
    return float(rel.max()), float(np.quantile(rel, 0.999))


def _cfgs(overrides):
    return (JaxFeatCfg(dither=0.0, **overrides),
            FeaturizerConfig(dither=0.0, **overrides))


@pytest.mark.parametrize("overrides,bsz,seconds,seed", CASES)
def test_fast_plain_matches_numpy_emulation(overrides, bsz, seconds, seed):
    jcfg, cfg = _cfgs(overrides)
    sig, _ = _audio(bsz, seconds, seed)
    xp = preemphasize_and_pad(torch.from_numpy(sig), cfg).contiguous()
    np.testing.assert_array_equal(xp.numpy(), _numpy_padded(sig, cfg))
    got = fast_mel_power_plain(
        xp, torch.from_numpy(_windowed_dft_matrix(cfg)),
        torch.from_numpy(_mel_matrix(cfg)), cfg=cfg)
    worst, p999 = _hold(got.numpy(), _emulated_mel_power(sig, jcfg, cfg))
    assert worst <= FLIP_TOL and p999 <= SUM_TOL, (worst, p999)


@pytest.mark.parametrize("overrides,bsz,seconds,seed", CASES)
def test_fast_kernel_operands_emulate_the_plain_version(overrides, bsz,
                                                        seconds, seed):
    """What csrc/frontend_fast.cu reads (fast_tables' bf16 DFT rows from
    k_lo, re and im of each bin in adjacent columns, the transposed bf16
    mel matrix) and the frame rows it views (f * hop + k_lo of the bf16
    samples), multiplied out in fp64 with the power rounded to bf16, give
    the plain version's mel power."""
    _, cfg = _cfgs(overrides)
    sig, _ = _audio(bsz, seconds, seed)
    xp = preemphasize_and_pad(torch.from_numpy(sig), cfg).contiguous()
    tables = fast_tables(cfg)
    k_lo, k_rows = tables.k_lo, tables.k_rows
    assert k_lo % 8 == 0 and k_rows % 16 == 0 and k_rows <= 320
    rows = xp.to(torch.bfloat16).double().unfold(
        1, cfg.fft_length, cfg.hop_length)[..., k_lo:k_lo + k_rows]
    spec = rows @ tables.dft.double().T                   # (B, T, 544)
    re, im = spec[..., 0::2].float(), spec[..., 1::2].float()
    power = (re * re + im * im).to(torch.bfloat16).double()
    got = (power @ tables.mel.double().T)[..., :cfg.features]
    want = fast_mel_power_plain(
        xp, torch.from_numpy(_windowed_dft_matrix(cfg)),
        torch.from_numpy(_mel_matrix(cfg)), cfg=cfg).double().numpy()
    worst, p999 = _hold(got.numpy(), want)
    assert worst <= FLIP_TOL and p999 <= SUM_TOL, (worst, p999)


@pytest.mark.parametrize("overrides", [{}, {"window": "ones"},
                                       {"features": 80}])
def test_fast_tables_hold_the_plain_operands(overrides):
    """fast_rows spans every nonzero window sample (the DFT rows outside
    it are exact zeros); the tables are the fp32 matrices' bf16 values in
    the kernel's layout, zero-padded."""
    cfg = FeaturizerConfig(dither=0.0, **overrides)
    k_lo, k_rows = fast_rows(cfg)
    nz = np.flatnonzero(_window_full(cfg).astype(np.float32))
    assert k_lo <= nz[0] and nz[-1] < k_lo + k_rows <= cfg.fft_length
    dft = _windowed_dft_matrix(cfg)
    assert not dft[:k_lo].any() and not dft[k_lo + k_rows:].any()
    tables = fast_tables(cfg)
    n_bins = cfg.fft_length // 2 + 1
    op = tables.dft.float().numpy().T.reshape(k_rows, FAST_BINS, 2)
    np.testing.assert_array_equal(op[:, :n_bins, 0],
                                  _bf16(dft[k_lo:k_lo + k_rows, :n_bins]))
    np.testing.assert_array_equal(op[:, :n_bins, 1],
                                  _bf16(dft[k_lo:k_lo + k_rows, n_bins:]))
    assert not op[:, n_bins:].any()
    mel = tables.mel.float().numpy()
    assert mel.shape == (-(-cfg.features // 8) * 8, FAST_BINS)
    np.testing.assert_array_equal(mel[:cfg.features, :n_bins],
                                  _bf16(_mel_matrix(cfg).T))
    assert not mel[cfg.features:].any() and not mel[:, n_bins:].any()


@pytest.mark.parametrize("overrides,bsz,seconds,seed", CASES)
def test_fast_partials_are_the_valid_frames_sums(overrides, bsz, seconds,
                                                 seed):
    """The plain version's partials: per 16-frame tile, the fp64 sums of
    its own log-mel frames inside seq_len (fp32 sums: 1e-5 of the
    largest)."""
    _, cfg = _cfgs(overrides)
    sig, lens = _audio(bsz, seconds, seed)
    xp = preemphasize_and_pad(torch.from_numpy(sig), cfg).contiguous()
    seq_len = feature_seq_len(torch.from_numpy(lens), cfg.hop_length)
    logmel, parts = log_mel_tiles_fast_plain(
        xp, seq_len, torch.from_numpy(_windowed_dft_matrix(cfg)),
        torch.from_numpy(_mel_matrix(cfg)), cfg=cfg)
    lm = logmel.double().numpy()
    n_tiles = -(-lm.shape[1] // FRAMES_PER_TILE)
    want = np.zeros((bsz, n_tiles, 2, cfg.features))
    for b in range(bsz):
        for f in range(int(seq_len[b])):
            want[b, f // FRAMES_PER_TILE, 0] += lm[b, f]
            want[b, f // FRAMES_PER_TILE, 1] += lm[b, f] ** 2
    assert parts.shape == want.shape
    assert np.abs(parts.double().numpy() - want).max() \
        <= 1e-5 * np.abs(want).max()
    assert torch.equal(parts, tile_partials(logmel, seq_len))


@pytest.mark.parametrize("overrides,bsz,seconds,seed", CASES)
def test_fast_featurizer_matches_jax_default_precision(overrides, bsz,
                                                       seconds, seed):
    jcfg, cfg = _cfgs(overrides)
    sig, lens = _audio(bsz, seconds, seed)
    want, want_len = jax_fused(jnp.asarray(sig), jnp.asarray(lens),
                               cfg=jcfg, interpret=True, precision="default")
    got, got_len = fused_log_mel_features(
        torch.from_numpy(sig), torch.from_numpy(lens), cfg=cfg,
        precision="default")
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    valid = np.arange(want.shape[1])[None, :] < np.asarray(want_len)[:, None]
    d = np.abs(got.numpy() - np.asarray(want))[valid]
    assert np.quantile(d, 0.99) <= P99_TOL and d.max() <= MAX_TOL
    assert np.median(d) > FP32_TOL
    assert not np.abs(got.numpy() - np.asarray(want))[~valid].any()


def test_fast_entry_points_agree_and_check_precision():
    """make_fused_featurizer(precision="default") on the CPU is the plain
    version bit for bit; an unknown precision raises."""
    cfg = FeaturizerConfig(dither=0.0)
    sig, lens = (torch.from_numpy(a) for a in _audio(2, 1.5, 5))
    got, got_len = make_fused_featurizer(cfg, device="cpu",
                                         precision="default")(sig, lens)
    want, want_len = fused_log_mel_features_plain(sig, lens, cfg=cfg,
                                                  precision="default")
    assert torch.equal(got, want) and torch.equal(got_len, want_len)
    highest, _ = fused_log_mel_features_plain(sig, lens, cfg=cfg)
    assert float((got - highest).abs().max()) > FP32_TOL
    for fn in (lambda: make_fused_featurizer(cfg, device="cpu",
                                             precision="fast"),
               lambda: fused_log_mel_features(sig, lens, cfg=cfg,
                                              precision="bf16"),
               lambda: fused_log_mel_features_plain(sig, lens, cfg=cfg,
                                                    precision="high")):
        with pytest.raises(ValueError, match="precision"):
            fn()


def test_fast_transcriber_matches_jax_default():
    """The full-width anchor: the port's fused_frontend="fast" Transcriber
    (bf16 encoder, the bf16 frontend's plain version) vs JAX's default
    Transcriber (bf16 encoder, the fp32 XLA frontend on the CPU)."""
    from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
    from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
    from vietasr_tpu_torch.models.convert import load_anchor
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    anchor = load_anchor(ANCHOR)
    jax_tr = JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions())
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(fused_frontend="fast"))
    rng = np.random.RandomState(0)
    for n in (24000, 30400, 49600):
        sig = (rng.randn(n) * 0.1).astype(np.float32)
        want, want_lens = jax_tr.log_probs(sig)
        got, got_lens = port.log_probs(sig)
        np.testing.assert_array_equal(got_lens, want_lens)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95
    assert isinstance(port.transcribe(sig), str)
