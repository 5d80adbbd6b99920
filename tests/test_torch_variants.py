"""The port's featurizer variants (frontend/variants.py) vs the JAX
package's: the power spectrogram and MFCCs at QuartzNet12x1_vi's
featurizer with ragged lengths, the DCT against JAX's and scipy's, the
batch repeater and the crop-or-pad of the time axis."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.fftpack import dct as scipy_dct

import jax.numpy as jnp

from vietasr_tpu import config as jax_config
from vietasr_tpu.frontend import features as jax_features
from vietasr_tpu.frontend import variants as jax_variants
from vietasr_tpu_torch import config
from vietasr_tpu_torch.frontend import features, variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VI_YAML = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                       "quartznet12x1_vi.yaml")
POWER_RTOL = 1e-5     # of each frame's largest power
FEATURE_TOL = 2e-4    # the log-mel tests' bar
# A log spectrogram bin (unlike a mel band, a sum of many bins) can hold a
# power ~1e-8 of its frame's largest, where the last bits of two fp32 DFT
# products of other summation orders move its log by ~1e-3 (both packages
# lie that far from an fp64 chain there). The 2e-4 bar holds on the bins
# at or above WELL_CONDITIONED of their frame's largest power; at every
# bin the port is held to the fp64 chain no further than 2x JAX is.
WELL_CONDITIONED = 1e-6


def _cfgs(**kw):
    port = dataclasses.replace(config.load_config(VI_YAML).featurizer, **kw)
    jax = dataclasses.replace(jax_config.load_config(VI_YAML).featurizer,
                              **kw)
    return port, jax


def _signals():
    rng = np.random.RandomState(0)
    lens = np.array([16000, 11025, 7001], np.int32)
    sig = np.zeros((3, 16000), np.float32)
    t = np.arange(16000) / 16000
    for i, n in enumerate(lens):
        sig[i, :n] = (0.1 * rng.randn(n)
                      + 0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t[:n]))
    return sig, lens


def _fp64_power(cfg, sig):
    dft = torch.as_tensor(features._windowed_dft_matrix(cfg),
                          dtype=torch.float64)
    xp = features.preemphasize_and_pad(torch.from_numpy(sig).double(), cfg)
    spec = xp.unfold(1, cfg.fft_length, cfg.hop_length) @ dft
    n_bins = cfg.fft_length // 2 + 1
    return (spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2).numpy()


def test_power_spectrum_matches_jax():
    cfg, jcfg = _cfgs()
    sig, _ = _signals()
    got = variants._power_spectrum(
        torch.from_numpy(sig), cfg,
        torch.as_tensor(features._windowed_dft_matrix(cfg))).numpy()
    want = np.asarray(jax_variants._power_spectrum(
        jnp.asarray(sig), jcfg,
        jnp.asarray(jax_features._windowed_dft_matrix(jcfg))))
    assert got.shape == want.shape == (3, 101, 257)
    scale = want.max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= POWER_RTOL * scale)


@pytest.mark.parametrize("normalize", ["per_feature", ""])
@pytest.mark.parametrize("log", [True, False])
def test_spectrogram_matches_jax(normalize, log):
    cfg, jcfg = _cfgs(normalize=normalize, log=log)
    sig, lens = _signals()
    got, got_len = variants.make_spectrogram_featurizer(cfg, device="cpu")(
        torch.from_numpy(sig), torch.from_numpy(lens))
    want, want_len = jax_variants.make_spectrogram_featurizer(jcfg)(
        jnp.asarray(sig), jnp.asarray(lens))
    want = np.asarray(want)
    assert np.array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape and got.dtype == torch.float32
    if log or normalize:
        power = _fp64_power(cfg, sig)
        valid = np.broadcast_to(np.arange(power.shape[1])[None, :, None]
                                < got_len.numpy()[:, None, None],
                                power.shape)
        well = valid & (power >= WELL_CONDITIONED
                        * power.max(axis=-1, keepdims=True))
        err = np.abs(got.numpy() - want)
        assert err[well].max() <= FEATURE_TOL, err[well].max()
        if not normalize:
            ref = np.log(power + cfg.log_zero_guard_value)
            assert np.abs(got.numpy() - ref)[valid].max() \
                <= 2 * np.abs(want - ref)[valid].max()
    else:
        scale = want.max(axis=-1, keepdims=True)
        assert np.all(np.abs(got.numpy() - want) <= POWER_RTOL * scale)
    # pad_value past each row's length
    for i, n in enumerate(got_len.tolist()):
        assert not bool(got[i, n:].any())


@pytest.mark.parametrize("normalize", ["per_feature", ""])
@pytest.mark.parametrize("n_mfcc", [13, 64])
@pytest.mark.parametrize("log,guard", [(True, "add"), (False, "clamp")])
def test_mfcc_matches_jax(normalize, n_mfcc, log, guard):
    """cfg.log and the guard type do not change the MFCCs (JAX always
    takes log(mel + guard value))."""
    cfg, jcfg = _cfgs(normalize=normalize, log=log, log_zero_guard_type=guard)
    sig, lens = _signals()
    got, got_len = variants.make_mfcc_featurizer(cfg, n_mfcc, device="cpu")(
        torch.from_numpy(sig), torch.from_numpy(lens))
    want, want_len = jax_variants.make_mfcc_featurizer(jcfg, n_mfcc)(
        jnp.asarray(sig), jnp.asarray(lens))
    assert np.array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == (3, 101, n_mfcc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FEATURE_TOL)
    base, _ = variants.make_mfcc_featurizer(
        dataclasses.replace(cfg, log=True, log_zero_guard_type="add"),
        n_mfcc, device="cpu")(torch.from_numpy(sig), torch.from_numpy(lens))
    assert torch.equal(got, base)


@pytest.mark.parametrize("n_mfcc,n_mels", [(13, 64), (64, 64), (20, 80)])
def test_dct_matches_jax_and_scipy(n_mfcc, n_mels):
    got = variants._dct_matrix(n_mfcc, n_mels)
    assert got.dtype == np.float32
    assert np.array_equal(got, jax_variants._dct_matrix(n_mfcc, n_mels))
    x = np.random.RandomState(n_mels).randn(n_mels).astype(np.float32)
    want = scipy_dct(x, type=2, norm="ortho")[:n_mfcc]
    np.testing.assert_allclose(got @ x, want, atol=1e-4)


def test_multiply_batch_matches_jax():
    rng = np.random.RandomState(1)
    arrs = [rng.randn(2, 10, 4).astype(np.float32),
            np.array([10, 6], np.int32),
            rng.randint(0, 5, size=(2, 3)).astype(np.int32),
            np.array([3, 2], np.int32)]
    got = variants.multiply_batch(*map(torch.from_numpy, arrs), mult=3)
    want = jax_variants.multiply_batch(*map(jnp.asarray, arrs), mult=3)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[0] == 6


@pytest.mark.parametrize("t,audio_length", [(10, 6), (11, 6), (10, 16),
                                            (9, 16), (10, 10)])
def test_crop_or_pad_matches_jax(t, audio_length):
    rng = np.random.RandomState(t)
    feats = rng.randn(2, t, 4).astype(np.float32)
    lens = np.array([t, t // 2], np.int32)
    got, got_len = variants.crop_or_pad_spectrogram(
        torch.from_numpy(feats), torch.from_numpy(lens),
        audio_length=audio_length, pad_value=-1.5)
    want, want_len = jax_variants.crop_or_pad_spectrogram(
        jnp.asarray(feats), jnp.asarray(lens), audio_length=audio_length,
        pad_value=-1.5)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.tolist() == [audio_length, audio_length]


def test_make_featurizers_default_to_cuda():
    cfg, _ = _cfgs()
    for make in (variants.make_spectrogram_featurizer,
                 variants.make_mfcc_featurizer):
        if torch.cuda.is_available():
            assert make(cfg).keywords["dft_matrix"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make(cfg)
