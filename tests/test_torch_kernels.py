"""vietasr_tpu_torch's CUDA kernels against their plain PyTorch versions.

The kernels run only on an NVIDIA GPU (sm_90a); those tests carry the
`cuda` marker and skip elsewhere. This file imports torch and the port
only, so on a machine with a GPU and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets JAX up). Tolerances:
2e-4 for the frontend (the JAX package's own); one bf16 rounding step of
the output, 2^-7 * max|want|, for the repeat block.
"""

import os

import numpy as np
import pytest
import torch

from vietasr_tpu_torch.frontend.cuda_frontend import (
    fused_log_mel_features, fused_log_mel_features_plain, log_mel_tiles_cuda,
    pack_dft)
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix,
                                                 _windowed_dft_matrix)
from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                fused_repeat_block_cuda,
                                                fused_repeat_block_plain)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTEND_TOL = 2e-4
REPEAT_REL_TOL = 2.0 ** -7


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _audio(bsz, seconds, seed, sr=16000):
    rng = np.random.RandomState(seed)
    sig = (rng.randn(bsz, int(seconds * sr)) * 0.1).astype(np.float32)
    lens = rng.randint(sr // 2, sig.shape[1] + 1, size=(bsz,)).astype(np.int32)
    return torch.from_numpy(sig), torch.from_numpy(lens)


def _block_operands(c_in, c_out, k, r, t, bsz=3, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32))
    cs = [c_in] + [c_out] * (r - 1)
    x = f(bsz, t, c_in, scale=0.5).to(torch.bfloat16)
    lens = torch.tensor([t, t - 7, t // 2][:bsz], dtype=torch.int32)
    return (x, lens, [f(k, c, scale=k ** -0.5) for c in cs],
            [f(c, c_out, scale=c ** -0.5).to(torch.bfloat16) for c in cs],
            [f(c_out, scale=0.1) for _ in cs],
            f(c_in, c_out, scale=c_in ** -0.5).to(torch.bfloat16),
            f(c_out, scale=0.1))


def test_frontend_kernel_refuses_cpu_tensors():
    """The CUDA entry never falls back: given CPU tensors it raises."""
    cfg = FeaturizerConfig(dither=0.0)
    xp = torch.zeros(1, 16000 + cfg.fft_length)
    dft = pack_dft(torch.as_tensor(_windowed_dft_matrix(cfg)),
                   cfg.fft_length // 2 + 1)
    with pytest.raises(ValueError, match="CUDA"):
        log_mel_tiles_cuda(xp, torch.tensor([100], dtype=torch.int32), dft,
                           torch.as_tensor(_mel_matrix(cfg)), cfg=cfg)


def test_repeat_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fused_repeat_block_cuda(*_block_operands(16, 16, 9, 1, 40), kernel=9)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,seconds,features", [(1, 2.0, 64),
                                                  (4, 5.3, 64),
                                                  (2, 1.3, 80)])
def test_frontend_kernel_matches_plain(bsz, seconds, features):
    _need_gpu()
    cfg = FeaturizerConfig(dither=0.0, features=features)
    sig, lens = (a.cuda() for a in _audio(bsz, seconds, bsz))
    launches = fused_log_mel_features.launches
    got, got_len = fused_log_mel_features(sig, lens, cfg=cfg)
    want, want_len = fused_log_mel_features_plain(sig, lens, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_log_mel_features.launches == launches + 1
    assert torch.equal(got_len, want_len)
    assert float((got - want).abs().max()) < FRONTEND_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,k,r,last_act", [
    (256, 512, 51, 1, False), (512, 512, 75, 1, False),
    (64, 64, 9, 3, False), (64, 128, 9, 2, True)])
def test_repeat_kernel_matches_plain(c_in, c_out, k, r, last_act):
    _need_gpu()
    args = [a.cuda() if torch.is_tensor(a) else [w.cuda() for w in a]
            for a in _block_operands(c_in, c_out, k, r, 200)]
    launches = fused_repeat_block.launches
    got = fused_repeat_block(*args, kernel=k, last_act=last_act).float()
    want = fused_repeat_block_plain(*args, kernel=k,
                                    last_act=last_act).float()
    torch.cuda.synchronize()
    assert fused_repeat_block.launches == launches + r
    assert float((got - want).abs().max()) \
        <= REPEAT_REL_TOL * float(want.abs().max())


@pytest.mark.cuda
def test_transcriber_goes_through_both_kernels():
    """One bf16 forward on the anchor: one frontend launch, one repeat
    launch for each of blocks 1-13."""
    _need_gpu()
    from vietasr_tpu_torch.pipeline import Transcriber

    tr = Transcriber(
        os.path.join(ROOT, "vietasr_tpu_torch/configs/quartznet12x1_vi.yaml"),
        checkpoint=os.path.join(ROOT,
                                "artifacts/real_speech_qn12x1_vi.msgpack.gz"))
    sig, _ = _audio(1, 3.0, 9)
    fused_log_mel_features.launches = fused_repeat_block.launches = 0
    lp, lens = tr.log_probs(sig.numpy()[0])
    assert (fused_log_mel_features.launches, fused_repeat_block.launches) \
        == (1, 13)
    assert np.isfinite(lp).all() and lens[0] == 150
