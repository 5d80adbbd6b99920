"""vietasr_tpu_torch log-mel frontend vs the JAX package's, on the CPU.

The same seeded numpy audio goes through both. Tolerance 2e-4 on the
normalized features is the JAX package's own for its fused frontend
(tests/test_pallas_frontend.py); the port's plain chain lands near 1e-5.
seq_len must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeatCfg
from vietasr_tpu.frontend.features import feature_seq_len as jax_seq_len
from vietasr_tpu.frontend.features import make_featurizer as jax_featurizer
from vietasr_tpu.frontend.pallas_frontend import \
    fused_log_mel_features as jax_fused
from vietasr_tpu_torch.frontend.cuda_frontend import (
    TAP_BASE, TWIDDLE_ROWS, fft_tables, fused_log_mel_features,
    fused_log_mel_features_plain, fused_supported, make_fused_featurizer,
    pack_mel_taps, twiddle_table)
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix, _window_full,
                                                 _windowed_dft_matrix,
                                                 feature_seq_len,
                                                 make_featurizer,
                                                 preemphasize_and_pad)

torch.set_num_threads(1)

TOL = 2e-4

# (config overrides, batch, seconds, seed), mirroring test_pallas_frontend:
# the vi config, lengths that land mid-tile, 80 mels, a single-tile clip
CASES = [({}, 2, 2.0, 0), ({}, 3, 3.7, 1), ({"features": 80}, 2, 1.3, 2),
         ({}, 2, 0.6, 3)]


def _audio(bsz, seconds, seed, sr=16000):
    rng = np.random.RandomState(seed)
    sig = (rng.randn(bsz, int(seconds * sr)) * 0.1).astype(np.float32)
    lens = rng.randint(sr // 2, sig.shape[1] + 1, size=(bsz,)).astype(np.int32)
    return sig, lens


def _cfgs(overrides):
    return (JaxFeatCfg(dither=0.0, **overrides),
            FeaturizerConfig(dither=0.0, **overrides))


@pytest.mark.parametrize("overrides,bsz,seconds,seed", CASES)
def test_plain_frontend_matches_jax(overrides, bsz, seconds, seed):
    jcfg, cfg = _cfgs(overrides)
    sig, lens = _audio(bsz, seconds, seed)
    want, want_len = jax_featurizer(jcfg)(jnp.asarray(sig), jnp.asarray(lens))
    got, got_len = make_featurizer(cfg, device="cpu")(torch.from_numpy(sig),
                                                      torch.from_numpy(lens))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL


@pytest.mark.parametrize("overrides,bsz,seconds,seed", CASES)
def test_fused_frontend_matches_jax_fused(overrides, bsz, seconds, seed):
    """The fused wrapper on CPU tensors (its plain version) vs the Pallas
    frontend in interpret mode, and vs the JAX plain chain."""
    jcfg, cfg = _cfgs(overrides)
    sig, lens = _audio(bsz, seconds, seed)
    want, want_len = jax_fused(jnp.asarray(sig), jnp.asarray(lens), cfg=jcfg,
                               interpret=True)
    chain, _ = jax_featurizer(jcfg)(jnp.asarray(sig), jnp.asarray(lens))
    launches = fused_log_mel_features.launches
    got, got_len = fused_log_mel_features(torch.from_numpy(sig),
                                          torch.from_numpy(lens), cfg=cfg)
    assert fused_log_mel_features.launches == launches   # no kernel on CPU
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
    assert np.abs(got.numpy() - np.asarray(chain)).max() < TOL


def test_fused_featurizer_binds_the_plain_matrices():
    cfg = FeaturizerConfig(dither=0.0)
    sig, lens = _audio(2, 1.0, 5)
    bound, _ = make_fused_featurizer(cfg, device="cpu")(
        torch.from_numpy(sig), torch.from_numpy(lens))
    direct, _ = fused_log_mel_features_plain(torch.from_numpy(sig),
                                             torch.from_numpy(lens), cfg=cfg)
    np.testing.assert_array_equal(bound.numpy(), direct.numpy())


def test_feature_seq_len_matches_jax():
    lens = np.array([0, 1, 159, 160, 161, 16000, 267200, 267199], np.int32)
    np.testing.assert_array_equal(
        feature_seq_len(torch.from_numpy(lens), 160).numpy(),
        np.asarray(jax_seq_len(jnp.asarray(lens), 160)))


def test_constant_matrices_match_jax():
    from vietasr_tpu.frontend import features as jf
    from vietasr_tpu.frontend.mel import mel_filterbank as jax_mel

    for overrides in ({}, {"features": 80}):
        jcfg, cfg = _cfgs(overrides)
        np.testing.assert_array_equal(_windowed_dft_matrix(cfg),
                                      jf._windowed_dft_matrix(jcfg))
        np.testing.assert_array_equal(
            _mel_matrix(cfg),
            jax_mel(16000, 512, cfg.features).T.astype(np.float32))


# A numpy transliteration of csrc/frontend.cu's per-frame schedule (one
# frame's 16 lanes as the last axis), so that its index bookkeeping and its
# sign conventions run on the CPU against numpy's FFT in fp64.
_C8, _S8, _H2 = (np.cos(np.pi / 8), np.sin(np.pi / 8), np.sqrt(0.5))


def _mul_w(z, c, s):
    return z.real * c + z.imag * s + 1j * (z.imag * c - z.real * s)


def _dft4(x0, x1, x2, x3):
    s0, d0, s1, d1 = x0 + x2, x0 - x2, x1 + x3, x1 - x3
    return (s0 + s1, d0.real + d1.imag + 1j * (d0.imag - d1.real), s0 - s1,
            d0.real - d1.imag + 1j * (d0.imag + d1.real))


def _pos16(k):
    return 4 * (k & 3) + (k >> 2)


def _dft16(a, real=np.float64):
    """a: list of 16 arrays; in place, output k ends at _pos16(k)."""
    for q in range(4):
        a[q], a[4 + q], a[8 + q], a[12 + q] = _dft4(a[q], a[4 + q],
                                                    a[8 + q], a[12 + q])
    for i, (c, s) in {5: (_C8, _S8), 6: (_H2, _H2), 7: (_S8, _C8),
                      9: (_H2, _H2), 10: (0.0, 1.0), 11: (-_H2, _H2),
                      13: (_S8, _C8), 14: (-_H2, _H2),
                      15: (-_C8, -_S8)}.items():
        a[i] = _mul_w(a[i], real(c), real(s))
    for r in range(4):
        a[4 * r:4 * r + 4] = _dft4(*a[4 * r:4 * r + 4])


def _kernel_power(frames, tables, real=np.float64):
    """(F, 512) fp32 frames -> (F, 257) power as the kernel forms it (in
    `real`, fp64 in the kernel, before its one rounding to fp32)."""
    win = tables.window.numpy().astype(np.float64)
    tw = tables.twiddle.numpy().astype(real)
    lane = np.arange(16)
    a = []
    for j in range(16):
        m = 2 * (lane + 16 * j)                         # (16,) lanes
        keep = (m + 1 >= tables.win_lo) & (m < tables.win_hi)
        v = (frames[:, m].astype(np.float64) * win[m]).astype(real) \
            + 1j * (frames[:, m + 1].astype(np.float64)
                    * win[m + 1]).astype(real)
        a.append(np.where(keep, v, real(0)))
    _dft16(a, real)
    for k1 in range(1, 16):
        w = tw[k1 * 16 + lane]
        a[_pos16(k1)] = _mul_w(a[_pos16(k1)], w[:, 0], w[:, 1])
    ex = np.stack([a[_pos16(k1)] for k1 in range(16)], axis=1)  # [k1][l]
    b = [ex[:, :, i] for i in range(16)]     # lane k1 reads row k1
    _dft16(b, real)
    partner = (16 - lane) % 16
    pw = np.zeros((frames.shape[0], 257))
    for k2 in range(8):
        zm = b[_pos16(15 - k2)][:, partner]
        zm[:, 0] = b[_pos16((16 - k2) % 16)][:, 0]
        z = b[_pos16(k2)]
        e, o = z + np.conj(zm), z - np.conj(zm)
        w = tw[256 + k2 * 16 + lane]
        p = _mul_w(o, w[:, 0], w[:, 1])
        k = lane + 16 * k2
        pw[:, k] = 0.25 * np.abs(e - 1j * p) ** 2
        pw[:, 256 - k] = 0.25 * np.abs(e + 1j * p) ** 2
    pw[:, 128] = np.abs(b[_pos16(8)][:, 0]) ** 2
    return pw


@pytest.mark.parametrize("features", [64, 80])
def test_fft_schedule_matches_fp64_spectrum(features):
    """The kernel's FFT schedule and its twiddle table give the power
    spectrum of the frames times its fp32 window taps to fp64 rounding."""
    cfg = FeaturizerConfig(dither=0.0, features=features)
    sig, _ = _audio(2, 0.5, 7)
    xp = preemphasize_and_pad(torch.from_numpy(sig), cfg)
    frames = xp.unfold(1, 512, 160).reshape(-1, 512).numpy()
    got = _kernel_power(frames, fft_tables(cfg))
    win = _window_full(cfg).astype(np.float32).astype(np.float64)
    want = np.abs(np.fft.rfft(frames.astype(np.float64) * win, axis=1)) ** 2
    assert np.abs(got - want).max() <= 1e-12 * want.max()


def test_fft_schedule_needs_fp64():
    """Why the kernel's FFT runs in fp64: on pre-emphasized noise the same
    schedule in fp32 puts the log-mel further from an fp64 chain than the
    plain fp32 chain (frames @ DFT matrix) is, and in fp64 it does not."""
    cfg = FeaturizerConfig(dither=0.0)
    sig, _ = _audio(2, 4.0, 11)
    xp = preemphasize_and_pad(torch.from_numpy(sig), cfg)
    frames = xp.unfold(1, 512, 160).reshape(-1, 512).numpy()
    mel, guard = _mel_matrix(cfg), np.float32(cfg.log_zero_guard_value)
    win = _window_full(cfg)
    want = np.log(np.abs(np.fft.rfft(frames.astype(np.float64) * win,
                                     axis=1)) ** 2 @ mel + guard)

    def log_mel(power):
        return np.log(power.astype(np.float32) @ mel + guard)

    spec = frames @ _windowed_dft_matrix(cfg)
    plain = log_mel(spec[:, :257] ** 2 + spec[:, 257:] ** 2)
    tables = fft_tables(cfg)
    err = {name: float(np.abs(got - want).max()) for name, got in (
        ("plain", plain), ("fp64", log_mel(_kernel_power(frames, tables))),
        ("fp32", log_mel(_kernel_power(frames, tables, np.float32))))}
    assert err["fp64"] <= err["plain"] < err["fp32"], err


def test_twiddle_table_matches_fp64_exp():
    """Row k1 * 16 + l is W256^(l k1), row 256 + k2 * 16 + l is
    W512^(l + 16 k2), as (cos, sin) of W = exp(-2 pi i e / N), each within
    2 fp64 ulp of the unreduced exponent's value."""
    tw = twiddle_table()
    assert tw.shape == (TWIDDLE_ROWS, 2) and tw.dtype == np.float64
    lane = np.arange(16)
    e = np.concatenate([(np.arange(16)[:, None] * lane[None, :]).ravel()
                        / 256, (lane[None, :] + 16 * np.arange(8)[:, None])
                        .ravel() / 512])
    want = np.exp(-2j * np.pi * e)
    got = tw[:, 0] - 1j * tw[:, 1]
    assert np.abs(got - want).max() <= 2 * np.spacing(1.0)


@pytest.mark.parametrize("features", [64, 80])
def test_fft_tables_window_and_mel_taps(features):
    """The window taps are the windowed DFT matrix's column 0 (cos 0 = 1),
    zero outside [win_lo, win_hi); the packed mel taps rebuild the mel
    matrix exactly, in at most 16 contiguous runs of filters."""
    cfg = FeaturizerConfig(dither=0.0, features=features)
    t = fft_tables(cfg)
    dft = _windowed_dft_matrix(cfg)
    assert torch.equal(t.window, torch.from_numpy(dft[:, 0]))
    assert (t.win_lo, t.win_hi) == (97, 415)
    assert not t.window[:t.win_lo].any() and not t.window[t.win_hi:].any()
    mel = _mel_matrix(cfg)
    idx, wt = t.mel_index.numpy(), t.mel_weight.numpy()
    starts, code = idx[:17], idx[TAP_BASE:]
    assert len(code) == len(wt) == t.taps and t.taps % 4 == 0
    assert starts[0] == 0 and starts[-1] == t.taps
    assert (np.diff(starts) >= 0).all() and not (starts % 4).any()
    rebuilt = np.zeros_like(mel)
    np.add.at(rebuilt, (code & 0x3ff, code >> 11), wt)
    np.testing.assert_array_equal(rebuilt, mel)
    last = code[(code & 0x400) != 0] >> 11
    np.testing.assert_array_equal(last, np.arange(features))
    assert int(np.count_nonzero(mel)) <= t.taps
    # no filter is split across two runs
    owner = np.searchsorted(starts, np.arange(t.taps), side="right") - 1
    for m in range(features):
        assert len(set(owner[(code >> 11) == m])) == 1
    assert np.diff(starts).max() <= -(-t.taps // 16) + 20


def test_pack_mel_taps_gives_an_empty_filter_one_zero_tap():
    """A filter with no nonzero weight still ends in one tap (weight 0),
    and each run is padded to 4 taps with weight-0 taps of its last filter
    that close nothing."""
    mel = np.zeros((257, 3), np.float32)
    mel[5:9, 0] = 1.0
    mel[40:41, 2] = 0.5
    idx, wt, taps = pack_mel_taps(mel, runs=2)
    assert taps == 8 and len(idx) == 4 + taps and len(wt) == taps
    assert list(idx[:4]) == [0, 4, 8, 0]
    code = idx[4:]
    np.testing.assert_array_equal(code >> 11, [0, 0, 0, 0, 1, 2, 2, 2])
    np.testing.assert_array_equal((code & 0x400) != 0,
                                  [0, 0, 0, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(wt, [1, 1, 1, 1, 0, 0.5, 0, 0])


def test_fused_supported_and_rejects_unsupported():
    from vietasr_tpu.frontend.pallas_frontend import \
        fused_supported as jax_supported

    for overrides in ({}, {"features": 80}, {"normalize": ""},
                      {"frame_splicing": 2}, {"mag_power": 1.0}):
        jcfg, cfg = _cfgs(overrides)
        assert fused_supported(cfg) == jax_supported(jcfg)
    cfg = FeaturizerConfig(dither=0.0, frame_splicing=2)
    with pytest.raises(NotImplementedError):
        fused_log_mel_features(torch.zeros(1, 16000),
                               torch.tensor([16000], dtype=torch.int32),
                               cfg=cfg)
