"""The fused frontends' normalization statistics on band-limited audio.

Both frontend kernels emit per-16-frame partials (sum, M2), M2 being the
sum of squares about the tile's own mean, and the epilogue merges them by
Chan et al.'s parallel formula (cuda_frontend.py::merge_tile_stats). The
one-pass formula it replaced, (sum x^2 - n mean^2) / (n - 1) in fp32 (the
JAX Pallas wrapper's), cancels on mel bins that hold nearly the same
value across a clip: 8 kHz audio upsampled to 16 kHz leaves the bins above
4 kHz nearly empty. These tests feed such audio, made from seeded numpy
noise, to the port's fused featurizer (its plain version, on the CPU), to
the JAX package's plain chain (features.py's two-pass _normalize) and to
an fp64 chain (an fp64 DFT of the same pre-emphasized frames, fp64
two-pass normalization with the epilogue's n and guard).

Tolerances. Against JAX's chain 2e-4, the JAX package's own fused-frontend
tolerance, where that chain is itself within it of fp64 (CHAIN_HELD). At
amplitude 0.001, and at 0.01 inside 4 s of digital silence, the far bins
sit at the log guard with fp64 stds of 5e-5 to 4e-3, where one fp32 ulp
of a log-mel value near -16.6 (1.9e-6) is 4e-4 to 4e-2 of a feature: JAX's
chain lands 1e-3 to 8e-2 from fp64 there. So every case is held as the
card holds the kernel route: no further from the fp64 chain than
max(2e-4, JAX's chain's distance); and at 0.001 at least 100x closer to
JAX's chain than the one-pass epilogue on the same log-mel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeatCfg
from vietasr_tpu.frontend.features import make_featurizer as jax_featurizer
from vietasr_tpu.frontend.pallas_frontend import \
    fused_log_mel_features as jax_fused
from vietasr_tpu_torch.audio.g711 import ulaw_decode, ulaw_encode
from vietasr_tpu_torch.frontend.cuda_frontend import (
    FRAMES_PER_TILE, fused_log_mel_features, log_mel_tiles_fast_plain,
    log_mel_tiles_plain, merge_tile_stats, tile_partials)
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix, _window_full,
                                                 _windowed_dft_matrix,
                                                 feature_seq_len,
                                                 mask_and_pad_time,
                                                 preemphasize_and_pad)
from vietasr_tpu_torch.ops.resample import make_device_resampler

torch.set_num_threads(1)

TOL = 2e-4
ONE_PASS_FACTOR = 100

_upsample = make_device_resampler(8000, 16000)


def _band_limited(kind, bsz, seconds, amp, seed):
    """(B, S) fp32 16 kHz audio of `seconds` at 8 kHz, upsampled by the
    port's device resampler: "noise" (seeded Gaussian x amp), "ulaw" (the
    same noise through G.711 mu-law and back) or "silence" (the noise with
    4 s of digital silence either side); (B,) ragged lengths, row 0
    full."""
    rng = np.random.RandomState(seed)
    x8 = (rng.randn(bsz, int(seconds * 8000)) * amp).astype(np.float32)
    if kind == "ulaw":
        x8 = ulaw_decode(ulaw_encode(x8)).astype(np.float32) / 32768.0
    elif kind == "silence":
        x8 = np.pad(x8, ((0, 0), (4 * 8000, 4 * 8000)))
    sig = _upsample(torch.from_numpy(x8)).numpy()
    n = sig.shape[1]
    lens = rng.randint(n // 2, n + 1, size=bsz).astype(np.int32)
    lens[0] = n
    return sig, lens


def _log_mel(sig, lens, cfg, precision="highest"):
    """The plain version's (log-mel, partials, seq_len) of the signals."""
    xp = preemphasize_and_pad(torch.from_numpy(sig), cfg).contiguous()
    seq_len = feature_seq_len(torch.from_numpy(lens), cfg.hop_length)
    tiles = log_mel_tiles_plain if precision == "highest" \
        else log_mel_tiles_fast_plain
    logmel, parts = tiles(xp, seq_len,
                          torch.from_numpy(_windowed_dft_matrix(cfg)),
                          torch.from_numpy(_mel_matrix(cfg)), cfg=cfg)
    return logmel, parts, seq_len


def _one_pass_features(logmel, seq_len, cfg):
    """The epilogue this file's merge replaced: per-tile fp32 (sum, sum
    of squares), var = max(s2 - n mean^2, 0) / max(n - 1, 1)."""
    parts = tile_partials(logmel, seq_len)
    valid = (torch.arange(logmel.shape[1])[None, :] < seq_len[:, None])
    sq = torch.where(valid[:, :, None], logmel * logmel, 0.0)
    n = torch.clamp_min(seq_len, 1).to(torch.float32)[:, None]
    mean = parts[:, :, 0].sum(1) / n
    s2 = torch.nn.functional.pad(
        sq, (0, 0, 0, parts.shape[1] * FRAMES_PER_TILE - sq.shape[1])
    ).reshape(sq.shape[0], parts.shape[1], FRAMES_PER_TILE, -1).sum(2).sum(1)
    var = torch.clamp_min(s2 - n * mean * mean, 0.0) \
        / torch.clamp_min(n - 1.0, 1.0)
    feats = (logmel - mean[:, None]) / (torch.sqrt(var)[:, None] + 1e-5)
    return mask_and_pad_time(feats, seq_len, logmel.shape[1], cfg)


def _two_pass_fp64(logmel, seq_len, cfg):
    """The fp64 two-pass normalization of a log-mel, with the fused
    epilogue's n = max(seq_len, 1) and +1e-5 std guard."""
    lm = logmel.double()
    valid = (torch.arange(lm.shape[1])[None, :]
             < seq_len[:, None])[:, :, None]
    n = torch.clamp_min(seq_len, 1).double()[:, None]
    mean = torch.where(valid, lm, 0.0).sum(1) / n
    dev = torch.where(valid, lm - mean[:, None], 0.0)
    var = (dev * dev).sum(1) / torch.clamp_min(n - 1.0, 1.0)
    feats = (lm - mean[:, None]) / (torch.sqrt(var)[:, None] + 1e-5)
    return mask_and_pad_time(feats, seq_len, lm.shape[1], cfg)


# (kind, seconds, amplitude): the resampled noise at 4 s and 16 s, the
# mu-law clip and the clip inside 4 s of silence either side at 4 s
STATS_CASES = [(kind, seconds, amp)
               for kind, secs in (("noise", (4.0, 16.0)), ("ulaw", (4.0,)),
                                  ("silence", (4.0,)))
               for seconds in secs for amp in (0.1, 0.01, 0.001)]
# the cases held to JAX's chain within TOL: those where that chain is
# within TOL of fp64 (5e-5 to 8e-5 measured; 1e-3 to 8e-2 in the others)
CHAIN_HELD = {(kind, seconds, amp) for kind, seconds, amp in STATS_CASES
              if amp == 0.1 or (amp == 0.01 and kind != "silence")}


def _fp64_features(sig, lens, cfg):
    """The fp64 chain: an fp64 DFT (rfft) of the fp32 pre-emphasized,
    padded frames with the fp64 window, power, the mel matrix, log with
    the guard, then _two_pass_fp64."""
    xp = preemphasize_and_pad(torch.from_numpy(sig), cfg).double()
    frames = xp.unfold(1, cfg.fft_length, cfg.hop_length) \
        * torch.from_numpy(_window_full(cfg))
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    logmel = torch.log(power @ torch.from_numpy(_mel_matrix(cfg)).double()
                       + cfg.log_zero_guard_value)
    seq_len = feature_seq_len(torch.from_numpy(lens), cfg.hop_length)
    return _two_pass_fp64(logmel, seq_len, cfg).numpy()


@pytest.mark.parametrize("kind,seconds,amp", STATS_CASES)
def test_fused_features_match_jax_chain_on_band_limited_audio(kind, seconds,
                                                              amp):
    """precision="highest": the fused featurizer on CPU tensors no
    further from the fp64 chain than max(TOL, JAX's plain chain's
    distance), within TOL of JAX's chain in CHAIN_HELD, and at 0.001
    ONE_PASS_FACTOR x closer to JAX's chain than the one-pass epilogue on
    the same log-mel."""
    cfg, jcfg = FeaturizerConfig(dither=0.0), JaxFeatCfg(dither=0.0)
    sig, lens = _band_limited(kind, 2, seconds, amp,
                              seed=int(seconds) + int(1 / amp))
    chain, chain_len = jax_featurizer(jcfg)(jnp.asarray(sig),
                                            jnp.asarray(lens))
    chain = np.asarray(chain)
    got, got_len = fused_log_mel_features(torch.from_numpy(sig),
                                          torch.from_numpy(lens), cfg=cfg)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(chain_len))
    assert got.shape == chain.shape
    got = got.numpy()
    want = _fp64_features(sig, lens, cfg)
    assert np.abs(got - want).max() <= max(TOL, np.abs(chain - want).max())
    err = float(np.abs(got - chain).max())
    if (kind, seconds, amp) in CHAIN_HELD:
        assert err < TOL
    if amp == 0.001:
        logmel, _, seq_len = _log_mel(sig, lens, cfg)
        one_pass = _one_pass_features(logmel, seq_len, cfg).numpy()
        assert err * ONE_PASS_FACTOR <= float(np.abs(one_pass - chain).max())


@pytest.mark.parametrize("kind,seconds,amp", STATS_CASES)
def test_fast_features_match_fp64_two_pass_of_own_log_mel(kind, seconds,
                                                          amp):
    """precision="default": the features against an fp64 two-pass
    normalization of the bf16 plain version's own log-mel, which isolates
    the epilogue from the bf16 rounding: within TOL at 0.1 and 0.01, and
    everywhere each feature within TOL + one fp32 ulp of the largest
    log-mel value over its bin's std + 1e-5 (the fp32 tile sums round
    each tile mean by up to half an ulp of the log-mel values)."""
    cfg = FeaturizerConfig(dither=0.0)
    sig, lens = _band_limited(kind, 2, seconds, amp,
                              seed=int(seconds) + int(1 / amp))
    got, _ = fused_log_mel_features(torch.from_numpy(sig),
                                    torch.from_numpy(lens), cfg=cfg,
                                    precision="default")
    logmel, _, seq_len = _log_mel(sig, lens, cfg, precision="default")
    want = _two_pass_fp64(logmel, seq_len, cfg)
    assert got.shape == want.shape
    err = (got.double() - want).abs()
    if amp >= 0.01:
        assert float(err.max()) < TOL
    lm = logmel.double()
    valid = (torch.arange(lm.shape[1])[None, :]
             < seq_len[:, None])[:, :, None]
    n = seq_len.double()[:, None]
    mean = torch.where(valid, lm, 0.0).sum(1) / n
    std = (torch.where(valid, lm - mean[:, None], 0.0) ** 2).sum(1) \
        .div(n - 1).sqrt()
    ulp = float(np.spacing(np.float32(lm.abs().max())))
    assert bool((err[:, :lm.shape[1]]
                 <= TOL + ulp / (std[:, None] + 1e-5)).all())


def _near_constant(bsz=4, t=61, n_mels=8, std=1e-3, seed=0):
    """fp32 log-mel rows of std `std` about -16.6 (a bin at the log
    guard) with seq_len 61 (a ragged last tile of 13 frames), 20 (tiles 2
    and 3 hold no valid frame), 1 and 0."""
    rng = np.random.RandomState(seed)
    lm = (-16.6 + std * rng.randn(bsz, t, n_mels)).astype(np.float32)
    return torch.from_numpy(lm), torch.tensor([61, 20, 1, 0][:bsz],
                                              dtype=torch.int32)


def test_tile_partials_hold_each_tiles_sum_and_m2():
    """Plane 0 is each tile's sum over the frames inside seq_len, plane 1
    their M2 about the tile's mean (0 where no frame is valid), against
    numpy fp64 on near-constant and on spread bins: each sum within one
    fp32 ulp of itself (rounded once from c v0 + sum d), each M2 within
    1e-5 of sum d^2, d = v - v0 the deviations from the tile's first
    frame it is taken over (fp32 sums of <= 16 small terms, each d
    exact)."""
    for std in (1e-3, 1.0):
        lm, seq_len = _near_constant(std=std)
        parts = tile_partials(lm, seq_len)
        n_tiles = -(-lm.shape[1] // FRAMES_PER_TILE)
        assert parts.shape == (4, n_tiles, 2, 8)
        lm64 = lm.double().numpy()
        want = np.zeros(parts.shape)
        scale = np.zeros((4, n_tiles, 8))
        for b in range(4):
            for i in range(n_tiles):
                rows = lm64[b, i * FRAMES_PER_TILE:min(
                    (i + 1) * FRAMES_PER_TILE, int(seq_len[b]))]
                if len(rows):
                    want[b, i, 0] = rows.sum(0)
                    want[b, i, 1] = ((rows - rows.mean(0)) ** 2).sum(0)
                    scale[b, i] = ((rows - rows[0]) ** 2).sum(0)
        sums, m2 = parts[:, :, 0].numpy(), parts[:, :, 1].double().numpy()
        assert (np.abs(sums - want[:, :, 0])
                <= np.spacing(np.abs(sums))).all()
        assert (np.abs(m2 - want[:, :, 1]) <= 1e-5 * scale).all()
        # the tiles past seq_len, the empty row and the seq_len = 1 row's
        # M2 are 0
        assert not parts[1, 2:].any() and not parts[3].any()
        assert not m2[2].any()


def test_merge_matches_fp64_two_pass_on_near_constant_bins():
    """merge_tile_stats against numpy's fp64 two-pass mean and unbiased
    variance (n = max(seq_len, 1), var = M2 / max(n - 1, 1)) on bins of
    std 1e-3 about -16.6, with a ragged last tile, tiles with no valid
    frame, a seq_len = 1 row and an empty one. Each tile sum is fp32, up
    to half an ulp (1.5e-5 below 512) from exact, which moves its tile
    mean by up to 1e-6: the mean (shift + offset) within 2e-6, one ulp
    of 16.6; the variance within 2e-3 of itself, since the cross-tile
    term weighs that 1e-6 by 2 c_i |m_i - mean|, with |m_i - mean| ~ std
    / 4: ~1e-6 / (2 std) = 5e-4 of the variance. The one-pass formula is
    off by more than the variance itself there."""
    lm, seq_len = _near_constant()
    shift, offset, var = merge_tile_stats(tile_partials(lm, seq_len),
                                          seq_len)
    mean = shift.double().numpy() + offset.double().numpy()
    var = var.double().numpy()
    lm64 = lm.double().numpy()
    for b in range(4):
        rows = lm64[b, :int(seq_len[b])]
        n = max(int(seq_len[b]), 1)
        want_mean = rows.sum(0) / n
        want_var = ((rows - want_mean) ** 2).sum(0) / max(n - 1, 1)
        assert np.abs(mean[b] - want_mean).max() <= 2e-6
        assert (np.abs(var[b] - want_var) <= 2e-3 * want_var).all()
        if n > 1:
            s = torch.from_numpy(rows.astype(np.float32))
            one_pass = ((s * s).sum(0) - n * (s.sum(0) / n) ** 2) / (n - 1)
            assert (np.abs(one_pass.double().numpy() - want_var)
                    > want_var).any()
    assert not var[2].any() and not var[3].any()


def test_jax_fused_frontend_cancels_on_band_limited_audio():
    """The JAX package's fault, recorded and not copied: its Pallas
    wrapper takes the variance in one fp32 pass from the tiles' (sum, sum
    of squares) (pallas_frontend.py's epilogue), so on 4 s of 8 kHz noise
    x 0.01 upsampled to 16 kHz its fused frontend (interpret mode) departs
    from its own plain chain by more than 1e-2, while the port's fused
    route stays within TOL of that chain."""
    jcfg = JaxFeatCfg(dither=0.0)
    sig, lens = _band_limited("noise", 2, 4.0, 0.01, seed=104)
    chain, _ = jax_featurizer(jcfg)(jnp.asarray(sig), jnp.asarray(lens))
    chain = np.asarray(chain)
    fused, _ = jax_fused(jnp.asarray(sig), jnp.asarray(lens), cfg=jcfg,
                         interpret=True)
    assert float(np.abs(np.asarray(fused) - chain).max()) > 1e-2
    got, _ = fused_log_mel_features(torch.from_numpy(sig),
                                    torch.from_numpy(lens),
                                    cfg=FeaturizerConfig(dither=0.0))
    assert float(np.abs(got.numpy() - chain).max()) < TOL
