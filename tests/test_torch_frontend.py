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
    fused_log_mel_features, fused_log_mel_features_plain, fused_supported,
    make_fused_featurizer, pack_dft)
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix,
                                                 _windowed_dft_matrix,
                                                 feature_seq_len,
                                                 make_featurizer)

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


def test_pack_dft_keeps_every_column():
    """The kernel's coefficient layout holds the DFT matrix's columns
    exactly: bins 0..255 as [re | im] rows, the rest as contiguous rows.
    The rows it skips are exactly zero: the 320-sample window sits at rows
    96..415 of 512, and its first and last samples are zero."""
    cfg = FeaturizerConfig(dither=0.0)
    nb = cfg.fft_length // 2 + 1
    dft = torch.as_tensor(_windowed_dft_matrix(cfg))
    coef, extra, row_lo, row_hi = pack_dft(dft, nb)
    assert (row_lo, row_hi) == (96, 416)
    assert not dft[:row_lo].any() and not dft[row_hi:].any()
    assert dft[row_lo + 1].any() and dft[row_hi - 2].any()
    assert coef.shape == (512, 512) and extra.shape == (nb - 256, 2, 512)
    assert coef.is_contiguous() and extra.is_contiguous()
    assert torch.equal(coef[:, :256], dft[:, :256])
    assert torch.equal(coef[:, 256:], dft[:, nb:nb + 256])
    assert torch.equal(extra[:, 0].t(), dft[:, 256:nb])
    assert torch.equal(extra[:, 1].t(), dft[:, nb + 256:])


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
