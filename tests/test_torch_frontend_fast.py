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
    FAST_BINS, FRAMES_PER_TILE, fast_dft_offset, fast_mel_offset,
    fast_mel_power_plain, fast_plan, fast_plan_smem, fast_rows,
    fast_shape_plan, fast_tables, fused_log_mel_features,
    fused_log_mel_features_plain, log_mel_tiles_fast_plain,
    make_fused_featurizer, tile_partials)
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


def _dft_operand(tables):
    """fast_tables' DFT operand read through fast_dft_offset: (2 *
    FAST_BINS, k_rows), column 2 b + 1 the imaginary part of bin b."""
    cols, ks = np.meshgrid(np.arange(2 * FAST_BINS), np.arange(tables.k_rows),
                           indexing="ij")
    return tables.dft[torch.from_numpy(
        fast_dft_offset(cols, ks, tables.k_rows))]


def _mel_operand(tables, n_mels):
    """fast_tables' mel bands read through fast_mel_offset:
    (ceil(n_mels / 8) * 8, FAST_BINS), zeros outside the held blocks."""
    ms, bins = np.meshgrid(np.arange(-(-n_mels // 8) * 8),
                           np.arange(FAST_BINS), indexing="ij")
    off = torch.from_numpy(fast_mel_offset(ms, bins, tables.mel_bands))
    return torch.where(off >= 0, tables.mel[off.clamp_min(0)],
                       torch.zeros((), dtype=tables.mel.dtype))


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
    spec = rows @ _dft_operand(tables).double().T         # (B, T, 544)
    re, im = spec[..., 0::2].float(), spec[..., 1::2].float()
    power = (re * re + im * im).to(torch.bfloat16).double()
    got = (power @ _mel_operand(tables, cfg.features).double().T
           )[..., :cfg.features]
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
    assert tables.dft.shape == (2 * FAST_BINS * k_rows,)
    op = _dft_operand(tables).float().numpy().T.reshape(k_rows, FAST_BINS,
                                                         2)
    np.testing.assert_array_equal(op[:, :n_bins, 0],
                                  _bf16(dft[k_lo:k_lo + k_rows, :n_bins]))
    np.testing.assert_array_equal(op[:, :n_bins, 1],
                                  _bf16(dft[k_lo:k_lo + k_rows, n_bins:]))
    assert not op[:, n_bins:].any()
    mel = _mel_operand(tables, cfg.features).float().numpy()
    assert mel.shape == (-(-cfg.features // 8) * 8, FAST_BINS)
    np.testing.assert_array_equal(mel[:cfg.features, :n_bins],
                                  _bf16(_mel_matrix(cfg).T))
    assert not mel[cfg.features:].any() and not mel[:, n_bins:].any()


@pytest.mark.parametrize("k_rows", [16, 320])
def test_fast_layouts_are_the_kernels_stages_and_fragments(k_rows):
    """fast_dft_offset and fast_mel_offset are one-to-one onto their
    tables. Each 32-column chunk of the DFT operand is one contiguous ring
    stage: 8 x 8 core matrices of 128 bytes, 8 columns apart by 128 bytes
    (the descriptor's SBO) and 8 rows of k apart by 512 (its LBO), the 16
    rows of a k16 step 1,024 bytes on. Each (8-mel tile, 16-bin step) of
    the mel matrix held is 256 contiguous bytes, lane l's 8 of them holding
    mma.sync's B fragment of mel l // 4 and bins 2 (l % 4) (+1, +8, +9)."""
    cols, ks = np.meshgrid(np.arange(2 * FAST_BINS), np.arange(k_rows),
                           indexing="ij")
    off = fast_dft_offset(cols, ks, k_rows)
    assert np.array_equal(np.sort(off.ravel()),
                          np.arange(2 * FAST_BINS * k_rows))
    stage = 32 * k_rows
    assert np.array_equal(off // stage, cols // 32)
    core = 2 * (off % stage) // 128               # bytes // 128
    assert np.array_equal(core, (ks // 8) * 4 + (cols % 32) // 8)
    assert np.array_equal(2 * (off % 64), (cols % 8) * 16 + (ks % 8) * 2)
    assert np.array_equal(2 * (off[:, 16:] - off[:, :-16]), np.full(
        (2 * FAST_BINS, k_rows - 16), 1024))
    ms, bins = np.meshgrid(np.arange(128), np.arange(FAST_BINS),
                           indexing="ij")
    moff = fast_mel_offset(ms, bins, ((0, FAST_BINS // 16),) * 16)
    assert np.array_equal(np.sort(moff.ravel()), np.arange(128 * FAST_BINS))
    run = moff // 128                             # 256-byte runs
    assert np.array_equal(run, (ms // 8) * (FAST_BINS // 16) + bins // 16)
    lane, word = (moff % 128) // 4, (moff % 4) // 2
    assert np.array_equal(lane, (ms % 8) * 4 + (bins % 8) // 2)
    assert np.array_equal(word, (bins % 16) // 8)
    assert np.array_equal(moff % 2, bins % 2)


@pytest.mark.parametrize("features", [1, 64, 80, 128])
def test_fast_mel_bands_hold_every_tap(features):
    """fast_tables holds, for each 8-mel tile of the bf16 filterbank, the
    16-bin blocks from its first to its last with a tap, one tile after
    another; every entry it leaves out is zero (24 of 136 blocks held at
    64 mels)."""
    cfg = FeaturizerConfig(dither=0.0, features=features)
    tables = fast_tables(cfg)
    mel8 = -(-features // 8) * 8
    want = np.zeros((mel8, FAST_BINS), np.float32)
    want[:features, :cfg.fft_length // 2 + 1] = _bf16(_mel_matrix(cfg).T)
    held = want.reshape(mel8 // 8, 8, FAST_BINS // 16, 16).any((1, 3))
    for t, (lo, n) in enumerate(tables.mel_bands):
        steps = np.flatnonzero(held[t])
        assert (lo, n) == (steps[0], steps[-1] - steps[0] + 1)
    blocks = sum(n for _, n in tables.mel_bands)
    assert tables.mel.numel() == 128 * blocks
    assert np.array_equal(_mel_operand(tables, features).float().numpy(),
                          want)
    ms, bins = np.meshgrid(np.arange(mel8), np.arange(FAST_BINS),
                           indexing="ij")
    off = fast_mel_offset(ms, bins, tables.mel_bands)
    assert np.array_equal(np.sort(off[off >= 0]),
                          np.arange(tables.mel.numel()))
    if features == 64:
        assert blocks == 24


# every hop the kernel takes, at the mel counts and DFT row counts at the
# ends of its reach (k_rows 320 is the 20 ms window)
PLAN_SHAPES = [(hop, n_mels, k_rows) for hop in range(8, 513, 8)
               for n_mels in (1, 64, 80, 128) for k_rows in (16, 320)]


@pytest.mark.parametrize("hop,n_mels,k_rows", PLAN_SHAPES)
def test_fast_plan_fits_every_shape_of_its_reach(hop, n_mels, k_rows):
    """Every shape the kernel took before its plan existed gets a plan that
    fits an H100 block's shared memory, with whole 64-frame warpgroups and
    a ring of at least 2 stages (the kernel holds 320 DFT rows, zero past
    the window's); the plan's bytes are fast_plan_smem's."""
    plan = fast_shape_plan(512, hop, n_mels, k_rows)
    assert plan is not None
    assert plan.frames in (64, 128) and plan.chunk_cols == 32
    assert 2 <= plan.stages <= 8
    assert plan.smem == fast_plan_smem(hop, plan.frames, plan.stages)
    assert plan.smem <= 232448
    assert fast_plan_smem(hop, plan.frames, plan.stages + 1) > 232448 \
        or plan.stages == 8
    if plan.frames == 64:          # 128 frames leave no room for 3 stages
        assert fast_plan_smem(hop, 128, 3) > 232448


@pytest.mark.parametrize("n_fft,hop,n_mels,k_rows", [
    (1024, 160, 64, 320), (512, 0, 64, 320), (512, 4, 64, 320),
    (512, 164, 64, 320), (512, 520, 64, 320), (512, 160, 0, 320),
    (512, 160, 129, 320), (512, 160, 64, 0), (512, 160, 64, 24),
    (512, 160, 64, 336), (512, 160, 64, 400)])
def test_fast_plan_refuses_shapes_outside_its_reach(n_fft, hop, n_mels,
                                                    k_rows):
    assert fast_shape_plan(n_fft, hop, n_mels, k_rows) is None


def test_fast_plan_of_the_shipped_configs():
    """The vi config (64 mels, hop 160, the 20 ms window's 320 rows) and
    its 80-mel twin: 128 frames a block, a 5-stage ring; a 25 ms window
    (400 rows) and a hop that is no multiple of 8 get none."""
    for features in (64, 80):
        plan = fast_plan(FeaturizerConfig(dither=0.0, features=features))
        assert (plan.frames, plan.stages) == (128, 5)
    assert fast_plan(FeaturizerConfig(dither=0.0, window_size=0.025)) is None
    assert fast_plan(FeaturizerConfig(dither=0.0,
                                      window_stride=0.0101)) is None


@pytest.mark.parametrize("overrides,bsz,seconds,seed", CASES)
def test_fast_partials_are_the_valid_frames_sums(overrides, bsz, seconds,
                                                 seed):
    """The plain version's partials: per 16-frame tile, the fp64 sum of
    its own log-mel frames inside seq_len and their M2 about the tile's
    mean (fp32 sums: 1e-5 of the largest)."""
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
        for i in range(n_tiles):
            rows = lm[b, i * FRAMES_PER_TILE:min(
                (i + 1) * FRAMES_PER_TILE, int(seq_len[b]))]
            if len(rows):
                want[b, i, 0] = rows.sum(0)
                want[b, i, 1] = ((rows - rows.mean(0)) ** 2).sum(0)
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
