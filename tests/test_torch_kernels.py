"""vietasr_tpu_torch's CUDA kernels against their plain PyTorch versions.

The kernels run only on an NVIDIA GPU (sm_90a); those tests carry the
`cuda` marker and skip elsewhere. This file imports torch and the port
only, so on a machine with a GPU and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(`--noconftest` skips tests/conftest.py, which sets JAX up). Tolerances:
2e-4 for the frontend (the JAX package's own); for the bf16 frontend
kernel (fused_frontend="fast") 2^-7 of each frame's largest mel power in
the mel-power domain (the kernel and its plain version differ only in the
order of fp32 sums, which can flip one power term's bf16 rounding: one
bf16 step of that term), partials within 1e-5 of the largest of those
summed from its own log-mel; the int8 GEMM equal bit for bit to the exact
product (fp32 products of the int8 values); one bf16 rounding step of
the output, 2^-7 * max|want|, for the repeat block; none for the beam
search, whose raw result (final state and backpointers) equals the plain
version's, ties included. The CTC pair: the alpha lattice and
the gradient within 1e-6 of the plain versions and, as measured, equal bit
for bit (the same fp32 formulas in the same order with the same expf/logf;
the exps the kernels skip are exactly 1 or add below half an ulp).
"""

import os

import numpy as np
import pytest
import torch

from vietasr_tpu_torch.frontend.cuda_frontend import (
    FRAMES_PER_TILE, FastPlan, fast_plan, fast_plan_smem, fast_tables,
    fft_tables, fused_log_mel_features, fused_log_mel_features_plain,
    log_mel_tiles_cuda, log_mel_tiles_fast_cuda, log_mel_tiles_fast_plain,
    log_mel_tiles_plain, tile_partials)
from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                 _mel_matrix, _window_full,
                                                 _windowed_dft_matrix,
                                                 feature_seq_len,
                                                 preemphasize_and_pad)
from vietasr_tpu_torch.ops import device_beam as tdb
from vietasr_tpu_torch.ops import fused_ctc
from vietasr_tpu_torch.ops.ctc_loss import emission_lookup, lattice_masks
from vietasr_tpu_torch.ops.fused_beam import (beam_search_cuda,
                                              fused_beam_search)
from vietasr_tpu_torch.ops.lm import (NGramLM, train_ngram_arpa,
                                      word_lm_tables)
from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                fused_repeat_block_cuda,
                                                fused_repeat_block_plain,
                                                repeat_chain_cuda,
                                                repeat_whole_block_cuda,
                                                whole_block_kernel_smem,
                                                whole_block_plan)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTEND_TOL = 2e-4
FAST_MEL_TOL = 2.0 ** -7
REPEAT_REL_TOL = 2.0 ** -7
CTC_TOL = 1e-6


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


def _block_operands(c_in, c_out, k, r, t, bsz=3, seed=0, lens=None,
                    x_dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * scale).astype(np.float32))
    cs = [c_in] + [c_out] * (r - 1)
    x = f(bsz, t, c_in, scale=0.5).to(x_dtype)
    lens = torch.tensor([t, t - 7, t // 2][:bsz] if lens is None else lens,
                        dtype=torch.int32)
    return (x, lens, [f(k, c, scale=k ** -0.5) for c in cs],
            [f(c, c_out, scale=c ** -0.5).to(torch.bfloat16) for c in cs],
            [f(c_out, scale=0.1) for _ in cs],
            f(c_in, c_out, scale=c_in ** -0.5).to(torch.bfloat16),
            f(c_out, scale=0.1))


def test_frontend_kernel_refuses_cpu_tensors():
    """The CUDA entry never falls back: given CPU tensors it raises."""
    cfg = FeaturizerConfig(dither=0.0)
    xp = torch.zeros(1, 16000 + cfg.fft_length)
    with pytest.raises(ValueError, match="CUDA"):
        log_mel_tiles_cuda(xp, torch.tensor([100], dtype=torch.int32),
                           fft_tables(cfg), cfg=cfg)


@pytest.mark.parametrize("overrides", [{"n_fft": 1024}, {"features": 129},
                                       {"window_stride": 0.04}])
def test_frontend_kernel_refuses_a_config_outside_its_plan(overrides):
    """n_fft other than 512 (the FFT's 16 x 16 plan), more than 128 mels,
    a hop longer than n_fft: refused before any launch."""
    cfg = FeaturizerConfig(dither=0.0, **overrides)
    xp = torch.zeros(1, 16000 + cfg.fft_length)
    with pytest.raises(ValueError, match="not covered"):
        log_mel_tiles_cuda(xp, torch.tensor([100], dtype=torch.int32),
                           fft_tables(FeaturizerConfig(dither=0.0)),
                           cfg=cfg)


def test_repeat_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fused_repeat_block_cuda(*_block_operands(16, 16, 9, 1, 40), kernel=9)


# 2.0 s and 1.3 s give 201 and 131 frames (not multiples of the 16-frame
# tile); row 0 of every batch is at full length, the others ragged
FRONTEND_CASES = [(1, 2.0, 64), (4, 5.3, 64), (2, 1.3, 80), (8, 16.7, 64),
                  (32, 16.7, 64), (8, 16.7, 80), (1, 16.7, 80),
                  (32, 2.0, 80), (8, 8.0, 64)]


def _frontend_audio(bsz, seconds, features):
    sig, lens = _audio(bsz, seconds, bsz + features)
    lens[0] = sig.shape[1]
    return sig.cuda(), lens.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,seconds,features", FRONTEND_CASES)
def test_frontend_kernel_matches_plain(bsz, seconds, features):
    _need_gpu()
    cfg = FeaturizerConfig(dither=0.0, features=features)
    sig, lens = _frontend_audio(bsz, seconds, features)
    launches = fused_log_mel_features.launches
    got, got_len = fused_log_mel_features(sig, lens, cfg=cfg)
    want, want_len = fused_log_mel_features_plain(sig, lens, cfg=cfg)
    torch.cuda.synchronize()
    assert fused_log_mel_features.launches == launches + 1
    assert torch.equal(got_len, want_len)
    assert float((got - want).abs().max()) < FRONTEND_TOL
    # the partials: fp32 sums of the same terms in another order
    tables = fft_tables(cfg, "cuda")
    dft = torch.as_tensor(_windowed_dft_matrix(cfg), device="cuda")
    mel = torch.as_tensor(_mel_matrix(cfg), device="cuda")
    xp = preemphasize_and_pad(sig, cfg).contiguous()
    seq_len = feature_seq_len(lens, cfg.hop_length)
    lm_k, parts_k = log_mel_tiles_cuda(xp, seq_len, tables, cfg=cfg)
    lm_p, parts_p = log_mel_tiles_plain(xp, seq_len, dft, mel, cfg=cfg)
    assert parts_k.shape == parts_p.shape == (
        bsz, -(-lm_p.shape[1] // FRAMES_PER_TILE), 2, features)
    assert float((parts_k - parts_p).abs().max()) \
        <= 1e-5 * float(parts_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,seconds,features", FRONTEND_CASES)
def test_frontend_kernel_no_further_from_fp64_than_plain(bsz, seconds,
                                                         features):
    """The accuracy contract: the kernel's log-mel frames (an FFT) lie no
    further from an fp64 chain (fp64 DFT of the same frames with the fp64
    window, power, mel, log) than the plain fp32 chain (frames @ DFT
    matrix) does."""
    _need_gpu()
    cfg = FeaturizerConfig(dither=0.0, features=features)
    sig, lens = _frontend_audio(bsz, seconds, features)
    dft = torch.as_tensor(_windowed_dft_matrix(cfg), device="cuda")
    mel = torch.as_tensor(_mel_matrix(cfg), device="cuda")
    xp = preemphasize_and_pad(sig, cfg).contiguous()
    seq_len = feature_seq_len(lens, cfg.hop_length)
    lm_k, _ = log_mel_tiles_cuda(xp, seq_len, fft_tables(cfg, "cuda"),
                                 cfg=cfg)
    lm_p, _ = log_mel_tiles_plain(xp, seq_len, dft, mel, cfg=cfg)
    win = torch.as_tensor(_window_full(cfg), device="cuda")
    frames = xp.double().unfold(1, cfg.fft_length, cfg.hop_length) * win
    want = torch.log((torch.fft.rfft(frames, dim=-1).abs() ** 2)
                     @ mel.double() + cfg.log_zero_guard_value)
    assert float((lm_k.double() - want).abs().max()) \
        <= float((lm_p.double() - want).abs().max())


def test_frontend_fast_kernel_refuses_cpu_tensors():
    """The bf16 kernel's entry never falls back: given CPU tensors it
    raises, before any build."""
    cfg = FeaturizerConfig(dither=0.0)
    xp = torch.zeros(1, 16000 + cfg.fft_length)
    with pytest.raises(ValueError, match="CUDA"):
        log_mel_tiles_fast_cuda(xp, torch.tensor([100], dtype=torch.int32),
                                fast_tables(cfg), cfg=cfg)
    with pytest.raises(TypeError, match="fast_tables"):
        log_mel_tiles_fast_cuda(xp, torch.tensor([100], dtype=torch.int32),
                                fft_tables(cfg), cfg=cfg)


# (B, seconds, mels, lengths or None for _frontend_audio's ragged ones):
# B = 1 to 32, 64 and 80 mels, a row of length 0 and one of length 1
FAST_CASES = [(1, 2.0, 64, None), (4, 5.3, 64, None), (2, 1.3, 80, None),
              (8, 16.7, 64, None), (32, 16.7, 64, None),
              (8, 16.7, 80, None), (32, 2.0, 80, None),
              (4, 2.0, 64, [32000, 0, 1, 16001]),
              (3, 0.7, 80, [11200, 1, 0])]


def _fast_case(bsz, seconds, features, lens, hop=160):
    sig, ragged = _frontend_audio(bsz, seconds, features)
    if lens is not None:
        ragged = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return (FeaturizerConfig(dither=0.0, features=features,
                             window_stride=hop / 16000), sig, ragged)


def _mel_power(logmel, cfg):
    return torch.exp(logmel.double()) - cfg.log_zero_guard_value


def _hold_fast_kernel(cfg, sig, lens, plan=None):
    """The bf16 kernel (under `plan`, default fast_plan) vs its plain
    version: one launch through fused_log_mel_features and none of the
    fp64 kernel, seq_len and shapes equal, finite features, the mel power
    within FAST_MEL_TOL of each frame's largest, the partials those of its
    own log-mel."""
    bsz, features = sig.shape[0], cfg.features
    launches = log_mel_tiles_fast_cuda.launches
    fp64_launches = fused_log_mel_features.launches
    got, got_len = fused_log_mel_features(sig, lens, cfg=cfg,
                                          precision="default")
    want, want_len = fused_log_mel_features_plain(sig, lens, cfg=cfg,
                                                  precision="default")
    torch.cuda.synchronize()
    assert log_mel_tiles_fast_cuda.launches == launches + 1
    assert fused_log_mel_features.launches == fp64_launches
    assert torch.equal(got_len, want_len) and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    dft = torch.as_tensor(_windowed_dft_matrix(cfg), device="cuda")
    mel = torch.as_tensor(_mel_matrix(cfg), device="cuda")
    xp = preemphasize_and_pad(sig, cfg).contiguous()
    seq_len = feature_seq_len(lens, cfg.hop_length)
    lm_k, parts_k = log_mel_tiles_fast_cuda(xp, seq_len,
                                            fast_tables(cfg, "cuda"),
                                            cfg=cfg, plan=plan)
    lm_p, parts_p = log_mel_tiles_fast_plain(xp, seq_len, dft, mel,
                                             cfg=cfg)
    want_mel = _mel_power(lm_p, cfg)
    rel = (_mel_power(lm_k, cfg) - want_mel).abs() \
        / want_mel.amax(-1, keepdim=True)
    assert float(rel.max()) <= FAST_MEL_TOL
    # the partials: the valid frames' sums of the kernel's own log-mel, in
    # the plain version's layout
    own = tile_partials(lm_k, seq_len)
    assert parts_k.shape == parts_p.shape == own.shape == (
        bsz, -(-lm_p.shape[1] // FRAMES_PER_TILE), 2, features)
    assert float((parts_k - own).abs().max()) \
        <= 1e-5 * float(own.abs().max())
    empty = seq_len == 0
    assert not parts_k[empty].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,seconds,features,lens", FAST_CASES)
def test_frontend_fast_kernel_matches_plain(bsz, seconds, features, lens):
    _need_gpu()
    _hold_fast_kernel(*_fast_case(bsz, seconds, features, lens))


# (hop, B, seconds, mels, lengths): the largest hop the launch plan takes
# with 64 mels (64-frame blocks), and B = 3 with rows whose frames end
# inside a 128-frame block and inside a 16-frame partials tile
FAST_PLAN_CASES = [(512, 2, 8.0, 64, None),
                   (160, 3, 16.7, 64, [267200, 69317, 36800])]


@pytest.mark.cuda
@pytest.mark.parametrize("hop,bsz,seconds,features,lens", FAST_PLAN_CASES)
def test_frontend_fast_kernel_matches_plain_at_the_plans_edges(
        hop, bsz, seconds, features, lens):
    _need_gpu()
    cfg, sig, lens = _fast_case(bsz, seconds, features, lens, hop)
    assert fast_plan(cfg).frames == (64 if hop == 512 else 128)
    _hold_fast_kernel(cfg, sig, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("frames,stages", [(64, 2), (64, 4), (64, 7)])
def test_frontend_fast_kernel_matches_plain_under_other_plans(frames,
                                                              stages):
    """The vi config under plans fast_plan does not pick for it: the
    results do not depend on the frames a block or the ring's depth."""
    _need_gpu()
    cfg, sig, lens = _fast_case(4, 5.3, 64, [84800, 0, 1, 40001])
    _hold_fast_kernel(cfg, sig, lens, FastPlan(
        frames, 32, stages, fast_plan_smem(cfg.hop_length, frames, stages)))


@pytest.mark.cuda
def test_frontend_fast_kernel_refuses_a_shape_outside_its_plan():
    """A hop that is not a multiple of 8 (frame rows not 16-byte aligned)
    and a 25 ms window (400 DFT rows, above the kernel's 320): refused
    before the launch."""
    _need_gpu()
    for overrides in ({"window_stride": 0.0101}, {"window_size": 0.025}):
        cfg = FeaturizerConfig(dither=0.0, **overrides)
        xp = torch.zeros(1, 16000 + cfg.fft_length, device="cuda")
        with pytest.raises(ValueError, match="plan"):
            log_mel_tiles_fast_cuda(
                xp, torch.tensor([100], dtype=torch.int32, device="cuda"),
                fast_tables(cfg, "cuda"), cfg=cfg)


# (M, K, N) of every int8 site of QuartzNet12x1 at B = 8 x 16.7 s (T =
# 840 after the stride-2 block) and at a 17-row and a 1104-row batch
INT8_SHAPES = [(6720, 64, 256), (6720, 256, 256), (6720, 256, 512),
               (6720, 512, 512), (6720, 1024, 96), (17, 64, 256),
               (1104, 64, 256), (5, 1024, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_gemm_matches_the_exact_gemm(m, k, n):
    _need_gpu()
    from vietasr_tpu_torch.models.quantize import (gemm_weight, int8_matmul,
                                                   int8_matmul_plain)

    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
    x[0] = 127
    w[:, 0] = 127                       # the largest partial sums
    got = int8_matmul(x.cuda(), gemm_weight(w.cuda()))[:, :n]
    want = x.long() @ w.long()
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu().long(), want)
    assert torch.equal(int8_matmul_plain(x, w).long(), want)


@pytest.mark.cuda
def test_transcriber_fast_and_int8_routes():
    """fused_frontend="fast": one bf16-frontend launch per forward, no
    fp64 FFT launch, 13 repeat launches. calibrate_int8: no repeat launch
    (every block per-op, as in JAX), frame argmax within JAX's bar of the
    bf16 float route."""
    _need_gpu()
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    cfg_path = os.path.join(ROOT,
                            "vietasr_tpu_torch/configs/quartznet12x1_vi.yaml")
    ckpt = os.path.join(ROOT, "artifacts/real_speech_qn12x1_vi.msgpack.gz")
    sig = _audio(1, 3.0, 9)[0].numpy()[0]
    fast = Transcriber(cfg_path, checkpoint=ckpt,
                       options=TranscriberOptions(fused_frontend="fast"))
    counters = (fused_log_mel_features, log_mel_tiles_fast_cuda,
                fused_repeat_block)
    for c in counters:
        c.launches = 0
    lp_fast, lens = fast.log_probs(sig)
    assert [c.launches for c in counters] == [0, 1, 13]
    base = Transcriber(cfg_path, checkpoint=ckpt)
    lp, _ = base.log_probs(sig)
    assert (lp_fast.argmax(-1) == lp.argmax(-1)).mean() >= 0.95
    base.calibrate_int8([sig])
    assert len(base._q_tables) == 28
    for c in counters:
        c.launches = 0
    lp_q, lens_q = base.log_probs(sig)
    assert [c.launches for c in counters] == [1, 0, 0]
    assert np.array_equal(lens, lens_q) and np.isfinite(lp_q).all()
    assert (lp_q.argmax(-1) == lp.argmax(-1)).mean() > 0.95


def _phase4_lens(c_in, c_out, k, r, t, bsz=8):
    """chip_smoke.py phase 4's ragged lengths for this block shape."""
    rng = np.random.RandomState(c_in + c_out + k + r)
    rng.randn(bsz, t, c_in)
    lens = rng.randint(t // 4, t + 1, size=bsz)
    lens[0] = t
    return lens.tolist()


def _repeat_case(c_in, c_out, k, r, last_act=False, t=200, bsz=3, lens=None,
                 x_dtype=torch.bfloat16, name=None):
    return pytest.param(c_in, c_out, k, r, last_act, t, bsz, lens, x_dtype,
                        id=name or f"{c_in}-{c_out}-{k}-{r}-{last_act}")


# R = 1: the one-repeat kernel takes 64-row tiles, or 32-row ones when
# their grid fits in one wave on the card (B = 2 and B = 3 here), splits
# the output columns of a small 32-row grid over two blocks, and skips the
# tiles that start at or past a row's length. R >= 2: the whole-block
# kernel, one launch a block, over a cluster of 1-8 blocks
# (whole_block_plan)
REPEAT_CASES = [
    _repeat_case(256, 512, 51, 1), _repeat_case(512, 512, 75, 1),
    _repeat_case(64, 64, 9, 3), _repeat_case(64, 128, 9, 2, True),
] + [
    # the 13 main-path blocks' 6 shapes at B = 8 x 16.7 s, ragged lengths
    _repeat_case(c_in, c_out, k, 1, t=840, bsz=8,
                 lens=_phase4_lens(c_in, c_out, k, 1, 840),
                 name=f"main-{c_in}-{c_out}-{k}")
    for c_in, c_out, k in ((256, 256, 33), (256, 256, 39), (256, 512, 51),
                           (512, 512, 51), (512, 512, 63), (512, 512, 75))
] + [
    _repeat_case(256, 256, 33, 1, t=1, bsz=2, lens=[1, 0], name="T1-len0"),
    _repeat_case(256, 256, 33, 1, t=65, bsz=2, lens=[65, 0], name="T65-len0"),
    _repeat_case(512, 512, 75, 1, t=200, bsz=2, lens=[200, 3],
                 name="T200-B2"),
    # a small grid splits a 512-wide output over two blocks per tile
    _repeat_case(256, 512, 51, 1, t=65, bsz=2, lens=[0, 40],
                 name="T65-len0-split-columns"),
    _repeat_case(64, 512, 9, 2, True, t=100, bsz=3, lens=[100, 0, 33],
                 name="R2-last_act-split-columns"),
    _repeat_case(256, 256, 33, 1, t=1000, bsz=8,
                 lens=[1000, 0, 1, 64, 65, 128, 999, 500],
                 name="64-row-tiles-len0-len1"),
    # fp32 input: staged as fp32 in the weight ring's memory, at 64-row and
    # at 32-row tiles
    _repeat_case(512, 512, 75, 1, t=840, bsz=8,
                 lens=_phase4_lens(512, 512, 75, 1, 840),
                 x_dtype=torch.float32, name="fp32-64-row-tiles"),
    _repeat_case(64, 128, 9, 2, x_dtype=torch.float32, name="fp32-R2"),
    _repeat_case(64, 64, 9, 3, True, t=840, bsz=8,
                 lens=_phase4_lens(64, 64, 9, 3, 840),
                 name="R3-last_act-64-row-tiles"),
] + [
    # QuartzNet15x5's six R = 5 block shapes at B = 8 x 16.7 s (clusters of
    # 4 and 8, 224 / 144 / 112-row tiles), ragged
    _repeat_case(c_in, c_out, k, 5, t=840, bsz=8,
                 lens=_phase4_lens(c_in, c_out, k, 5, 840),
                 name=f"15x5-{c_in}-{c_out}-{k}")
    for c_in, c_out, k in ((256, 256, 33), (256, 256, 39), (256, 512, 51),
                           (512, 512, 51), (512, 512, 63), (512, 512, 75))
] + [
    # a halo (5 x 37 rows a side) wider than T, a zero-length row and a
    # length-1 row; 16-row tiles of a small grid
    _repeat_case(512, 512, 75, 5, t=40, bsz=3, lens=[40, 0, 1],
                 name="15x5-K75-halo-wider-than-T"),
    _repeat_case(256, 512, 51, 5, t=1, bsz=2, lens=[1, 0], name="R5-T1"),
    _repeat_case(256, 256, 33, 5, t=200, bsz=3, lens=[200, 17, 0],
                 x_dtype=torch.float32, name="R5-fp32"),
    _repeat_case(512, 512, 63, 5, True, t=300, bsz=2, lens=[300, 131],
                 name="R5-last_act"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,k,r,last_act,t,bsz,lens,x_dtype",
                         REPEAT_CASES)
def test_repeat_kernel_matches_plain(c_in, c_out, k, r, last_act, t, bsz,
                                     lens, x_dtype):
    _need_gpu()
    args = [a.cuda() if torch.is_tensor(a) else [w.cuda() for w in a]
            for a in _block_operands(c_in, c_out, k, r, t, bsz, lens=lens,
                                     x_dtype=x_dtype)]
    launches = (fused_repeat_block.launches,
                repeat_whole_block_cuda.launches)
    got = fused_repeat_block(*args, kernel=k, last_act=last_act).float()
    want = fused_repeat_block_plain(*args, kernel=k,
                                    last_act=last_act).float()
    torch.cuda.synchronize()
    # one launch a block: the one-repeat kernel at R = 1, else the whole
    assert (fused_repeat_block.launches, repeat_whole_block_cuda.launches) \
        == (launches[0] + (r == 1), launches[1] + (r > 1))
    assert float((got - want).abs().max()) \
        <= REPEAT_REL_TOL * float(want.abs().max())


@pytest.mark.cuda
def test_whole_block_plan_matches_the_built_kernel():
    """The plan's shared-memory count is the kernel's own, for every
    15x5 shape, and the launch fits it."""
    _need_gpu()
    for c_in, c_out, k in ((256, 256, 33), (256, 256, 39), (256, 512, 51),
                           (512, 512, 51), (512, 512, 63), (512, 512, 75)):
        for bsz, t in ((8, 840), (2, 100)):
            plan = whole_block_plan(bsz, t, c_in, c_out, k, 5)
            assert whole_block_kernel_smem(plan, k, 5) == plan.smem_bytes


@pytest.mark.cuda
def test_whole_block_raises_and_never_falls_back():
    """An R >= 2 shape no plan takes raises ValueError naming the shape;
    nothing is launched, neither the chain nor the plain version."""
    _need_gpu()
    args = [a.cuda() if torch.is_tensor(a) else [w.cuda() for w in a]
            for a in _block_operands(512, 1024, 9, 2, 40)]
    launches = (fused_repeat_block.launches,
                repeat_whole_block_cuda.launches)
    with pytest.raises(ValueError, match="C_out=1024"):
        fused_repeat_block(*args, kernel=9)
    assert (fused_repeat_block.launches,
            repeat_whole_block_cuda.launches) == launches


@pytest.mark.cuda
def test_repeat_chain_matches_plain():
    """The yardstick chip_smoke.py times (R launches of the one-repeat
    kernel) computes the same block."""
    _need_gpu()
    args = [a.cuda() if torch.is_tensor(a) else [w.cuda() for w in a]
            for a in _block_operands(256, 512, 51, 5, 300, bsz=2,
                                     lens=[300, 77])]
    got = repeat_chain_cuda(*args, kernel=51).float()
    want = fused_repeat_block_plain(*args, kernel=51).float()
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


def _beam_inputs(bsz, t, w, seed, order, tmp_path, device, ties=False,
                 lens=None):
    """Seeded log-probs over 5 classes (space = 3, blank = 4), ragged
    lengths, the start state and a word LM of `order` (or none). `ties`
    rounds the logits to multiples of 0.25 before the log-softmax, so that
    many candidate totals tie and the select's index tie-break decides."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(bsz, t, 5) * 1.8).astype(np.float32)
    if ties:
        x = np.round(x * 4.0) / 4.0
    lp = torch.log_softmax(torch.from_numpy(x), dim=-1).to(device)
    if lens is None:
        lens = [t] + [max(1, t - 5 * i) for i in range(1, bsz)]
    lens = torch.tensor(lens, dtype=torch.int32, device=device)
    word_lm, probes = None, 8
    if order:
        arpa = str(tmp_path / f"w{order}.arpa")
        train_ngram_arpa(["ab cab ba c", "ab ba cab ba", "cab ab ba c ab",
                          "ba cab ab ba"] * 2, arpa, order=order)
        tables, probes = word_lm_tables(NGramLM(arpa), ["a", "b", "c", " "])
        word_lm = tdb.word_lm_to_device(tables, device)
    return lp, lens, word_lm, probes


def test_beam_kernel_refuses_cpu_tensors(tmp_path):
    lp, lens, wl, probes = _beam_inputs(2, 10, 8, 0, 3, tmp_path, "cpu")
    top_lp, top_ci = tdb.frame_topk(lp, 3)
    state = tdb.init_packed_state(2, 8, wl)
    with pytest.raises(ValueError, match="CUDA"):
        beam_search_cuda(lp, lens, top_lp, top_ci, state, blank=4, space=3,
                         word_lm=wl, wlm_probes=probes)


# (W, K, LM order, case): "ties" rounds the logits (many equal totals);
# "ragged" has rows whose lengths differ by more than 2x (one stops after
# a frame)
BEAM_CASES = [(8, 3, 0, ""), (12, 4, 3, ""), (16, 3, 5, ""), (100, 4, 2, ""),
              (100, 4, 3, "ties"), (128, 4, 3, ""), (50, 3, 3, "ragged")]


@pytest.mark.cuda
@pytest.mark.parametrize("w,k,order,case", BEAM_CASES)
def test_beam_kernel_matches_plain(w, k, order, case, tmp_path):
    _need_gpu()
    t = 24
    lens = [t, t // 2 - 1, t // 5, 1] if case == "ragged" else None
    lp, lens, wl, probes = _beam_inputs(
        3 if lens is None else len(lens), t, w, w + order, order, tmp_path,
        "cuda", ties=case == "ties", lens=lens)
    kw = dict(beam_width=w, cutoff_top_n=k, space=3, alpha=0.5, beta=1.5,
              word_lm=wl, wlm_probes=probes)
    launches = fused_beam_search.launches
    got = fused_beam_search(lp, lens, blank=4, return_raw=True, **kw)
    want = tdb.device_beam_search(lp, lens, blank=4, return_raw=True, **kw)
    torch.cuda.synchronize()
    assert fused_beam_search.launches == launches + 1
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    ids, n = fused_beam_search(lp, lens, blank=4, **kw)
    want_ids, want_n = tdb.device_beam_search(lp, lens, blank=4, **kw)
    assert torch.equal(n, want_n) and torch.equal(ids, want_ids)


@pytest.mark.cuda
def test_beam_kernel_wide_top_k_matches_plain(tmp_path):
    """The kernel's largest shared-memory plan: W = 128 and K = 90 of 91
    classes with a word 5-gram (over the first 4 labels)."""
    _need_gpu()
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(2, 6, 92) * 1.8).astype(np.float32))
    lp = torch.log_softmax(x, dim=-1).cuda()
    lens = torch.tensor([6, 4], dtype=torch.int32, device="cuda")
    arpa = str(tmp_path / "w5.arpa")
    train_ngram_arpa(["ab cab ba c", "ab ba cab ba", "cab ab ba c ab"] * 2,
                     arpa, order=5)
    labels = ["a", "b", "c", " "] + [chr(0x100 + i) for i in range(87)]
    tables, probes = word_lm_tables(NGramLM(arpa), labels)
    kw = dict(beam_width=128, cutoff_top_n=90, space=3, alpha=0.5, beta=1.5,
              word_lm=tdb.word_lm_to_device(tables, "cuda"),
              wlm_probes=probes)
    got = fused_beam_search(lp, lens, blank=91, return_raw=True, **kw)
    want = tdb.device_beam_search(lp, lens, blank=91, return_raw=True, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_beam_kernel_large_lm_matches_plain(tmp_path):
    """A word 3-gram of more than 4,096 table rows, which the kernel probes
    in device memory instead of its shared-memory copy."""
    _need_gpu()
    rng = np.random.RandomState(3)
    words = ["".join("abc"[i] for i in rng.randint(0, 3, size=n))
             for n in rng.randint(1, 6, size=400)]
    arpa = str(tmp_path / "big3.arpa")
    train_ngram_arpa([" ".join(rng.choice(words, size=8))
                      for _ in range(1500)], arpa, order=3)
    tables, probes = word_lm_tables(NGramLM(arpa), ["a", "b", "c", " "])
    assert np.asarray(tables.packed).shape[0] > 4096
    lp, lens, _, _ = _beam_inputs(3, 40, 100, 11, 0, tmp_path, "cuda",
                                  lens=[40, 17, 3])
    kw = dict(beam_width=100, cutoff_top_n=4, space=3, alpha=0.5, beta=1.5,
              word_lm=tdb.word_lm_to_device(tables, "cuda"),
              wlm_probes=probes)
    got = fused_beam_search(lp, lens, blank=4, return_raw=True, **kw)
    want = tdb.device_beam_search(lp, lens, blank=4, return_raw=True, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def _beam_one_launch(tmp_path, device):
    """decoder="device_beam" on `device` decodes every forward of a
    transcribe_batch call in one kernel launch. Five signals over two
    buckets with max_batch=2 refill the 2 s bucket's page-locked buffer
    before anything is read back; the texts equal those of each forward's
    group decoded on its own (the same forwards, so the same log-probs)."""
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    arpa = str(tmp_path / "vi3.arpa")
    train_ngram_arpa(["xin chào các bạn", "chào mừng quý vị",
                      "bản tin thời sự hôm nay"] * 2, arpa, order=3)
    tr = Transcriber(
        os.path.join(ROOT, "vietasr_tpu_torch/configs/quartznet12x1_vi.yaml"),
        checkpoint=os.path.join(ROOT,
                                "artifacts/real_speech_qn12x1_vi.msgpack.gz"),
        options=TranscriberOptions(decoder="device_beam", lm_path=arpa,
                                   beam_width=16, max_batch=2),
        device=device)
    rng = np.random.RandomState(5)
    sigs = [(rng.randn(n) * 0.1).astype(np.float32)
            for n in (20000, 52000, 16000, 27000, 60000)]
    want = [None] * len(sigs)
    for group in ([2, 0], [3], [1, 4]):       # the call's forwards
        for i, text in zip(group, tr.transcribe_batch([sigs[i]
                                                       for i in group])):
            want[i] = text
    fused_beam_search.launches = 0
    assert tr.transcribe_batch(sigs) == want
    assert fused_beam_search.launches == 1


@pytest.mark.cuda
def test_transcriber_beam_one_launch_per_call(tmp_path):
    _need_gpu()
    _beam_one_launch(tmp_path, None)


@pytest.mark.cuda
def test_transcriber_beam_on_second_device(tmp_path):
    """The same on cuda:1 while cuda:0 is current: each upload's event is
    recorded on the stream that made the copy, cuda:1's."""
    _need_gpu()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second NVIDIA GPU")
    assert torch.cuda.current_device() == 0
    _beam_one_launch(tmp_path, "cuda:1")


@pytest.mark.cuda
def test_beam_kernel_counts_its_steps(tmp_path):
    """With `stats`, the kernel reports per row the block-wide barriers its
    steps took (5, or 6 in a step that ranks its keys in sorted runs) and
    the keys >= its threshold it ranked (at least W a step: the threshold
    lets the W best through), and the raw result does not change."""
    _need_gpu()
    lens = [40, 17, 1, 0]
    lp, lens, wl, probes = _beam_inputs(4, 40, 100, 3, 3, tmp_path, "cuda",
                                        lens=lens)
    top_lp, top_ci = tdb.frame_topk(lp, 3)       # contiguous for K < V
    state = tdb.init_packed_state(4, 100, wl, "cuda")
    kw = dict(blank=4, space=3, alpha=0.5, beta=1.5, word_lm=wl,
              wlm_probes=probes)
    stats = torch.full((4, 2), -1, dtype=torch.int64, device="cuda")
    got = beam_search_cuda(lp, lens, top_lp, top_ci, state, stats=stats, **kw)
    want = beam_search_cuda(lp, lens, top_lp, top_ci, state, **kw)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    steps = lens.long().cpu()
    barriers, ranked = stats.cpu().unbind(1)
    assert ((5 * steps <= barriers) & (barriers <= 6 * steps)).all()
    assert ((100 * steps <= ranked) & (ranked <= 400 * steps)).all()


@pytest.mark.cuda
def test_beam_kernel_refuses_bad_inputs(tmp_path):
    _need_gpu()
    lp, lens, wl, probes = _beam_inputs(2, 10, 8, 0, 3, tmp_path, "cuda")
    top_lp, top_ci = tdb.frame_topk(lp, 3)
    state = tdb.init_packed_state(2, 8, wl, "cuda")
    kw = dict(blank=4, space=3, word_lm=wl, wlm_probes=probes)
    with pytest.raises(ValueError, match="float32"):
        beam_search_cuda(lp.double(), lens, top_lp, top_ci, state, **kw)
    with pytest.raises(ValueError, match="int32"):
        beam_search_cuda(lp, lens.long(), top_lp, top_ci, state, **kw)
    wide = tdb.init_packed_state(2, 129, wl, "cuda")
    with pytest.raises(ValueError, match="beam width"):
        beam_search_cuda(lp, lens, top_lp, top_ci, wide, **kw)
    with pytest.raises(ValueError, match="beam_width"):
        fused_beam_search(lp, lens, beam_width=129, cutoff_top_n=3, **kw)


def _ctc_lattice(bsz, t, l, seed, device, ilens=None):
    """Seeded (B, T, S) lattice inputs over 7 classes (blank 6): ragged
    input lengths (or `ilens`), row 0 with repeated labels, row 1 (if any)
    with target length 0, row 2 (if any) infeasible; l = 0 gives every row
    target length 0 (S = 1)."""
    rng = np.random.RandomState(seed)
    lp = torch.log_softmax(torch.from_numpy(
        (rng.randn(bsz, t, 7) * 2).astype(np.float32)), dim=-1)
    targets = torch.from_numpy(rng.randint(0, 6, size=(bsz, l)))
    ilen = torch.from_numpy(rng.randint(max(t // 2, 1), t + 1, size=bsz)
                            .astype(np.int32))
    tlen = torch.from_numpy(rng.randint(1, l + 1, size=bsz).astype(np.int32)
                            if l else np.zeros(bsz, np.int32))
    ilen[0], tlen[0] = t, l
    targets[0, : l // 2] = 3
    if bsz > 1:
        tlen[1] = 0
    if bsz > 2:
        ilen[2], tlen[2] = max(l // 4, 1), l
    if ilens is not None:
        ilen = torch.tensor(ilens, dtype=torch.int32)
    ext, can, valid = lattice_masks(targets, tlen, 6)
    lp_ext = emission_lookup(lp, ext).contiguous()
    return [a.to(device) for a in (lp_ext, can, valid, ilen, tlen)]


def test_ctc_kernels_refuse_cpu_tensors():
    lp_ext, can, valid, ilen, tlen = _ctc_lattice(2, 12, 3, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        fused_ctc.ctc_alpha_cuda(lp_ext, can, valid, ilen)
    ll = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ctc.ctc_beta_cuda(lp_ext, lp_ext, can, valid, ilen, tlen, ll,
                                torch.ones(2))


def _ctc_pair(lp_ext, can, valid, ilen, tlen, plan=(None, None)):
    """(alphas, ll, grad) through the kernels and through the plain
    versions, with ybar spread over [0.5, 1.5]."""
    bsz = lp_ext.shape[0]
    ybar = torch.linspace(0.5, 1.5, bsz, device=lp_ext.device)
    alphas = fused_ctc.ctc_alpha_cuda(lp_ext, can, valid, ilen, plan=plan[0])
    ll = fused_ctc.final_ll(alphas[:, -1], tlen)
    grad = fused_ctc.ctc_beta_cuda(lp_ext, alphas, can, valid, ilen, tlen,
                                   ll, ybar, plan=plan[1])
    want_alphas = fused_ctc.ctc_alpha_plain(lp_ext, can, valid, ilen)
    want_grad = fused_ctc.ctc_beta_plain(lp_ext, want_alphas, can, valid,
                                         ilen, tlen, ll, ybar)
    torch.cuda.synchronize()
    return (alphas, ll, grad), (want_alphas, want_grad)


CTC_CASES = {
    # S = 2L + 1 of 19, 25, 1025 (8 positions a thread) and 201; B = 1 and
    # ragged lengths; a repeated label run, a target length 0 and an
    # infeasible row
    "S19": (5, 60, 9, None), "B1-S25": (1, 40, 12, None),
    "S1025": (3, 1100, 512, None), "S201": (4, 200, 100, None),
    # T = 1; T = 3, below every prefetch ring's depth
    "T1": (3, 1, 2, None), "T3": (4, 3, 5, None),
    # input lengths 0 and 1
    "len0-len1": (4, 50, 10, [0, 1, 2, 25]),
    # every row of target length 0: S = 1
    "S1": (6, 30, 0, None),
    # S = 4095 (L = 2047), the widest lattice the kernels take
    "S4095": (2, 4200, 2047, None),
    # the training shape: B = 32, T = 840, S = 435
    "train-B32-S435": (32, 840, 217, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CTC_CASES))
def test_ctc_kernels_match_plain(case):
    """The kernels under their default launch plan against the plain
    versions, bit for bit, at shapes that reach the schedule's edges (S is
    2L + 1, odd, so never a multiple of the 2, 4 or 8 positions a thread
    owns)."""
    _need_gpu()
    bsz, t, l, ilens = CTC_CASES[case]
    lp_ext, can, valid, ilen, tlen = _ctc_lattice(bsz, t, l, bsz + t, "cuda",
                                                  ilens)
    n_alpha, n_beta = fused_ctc.fused_ctc_alpha.launches, \
        fused_ctc.fused_ctc_beta.launches
    alphas = fused_ctc.fused_ctc_alpha(lp_ext, can, valid, ilen)
    ll = fused_ctc.final_ll(alphas[:, -1], tlen)
    ybar = torch.linspace(0.5, 1.5, bsz, device="cuda")
    grad = fused_ctc.fused_ctc_beta(lp_ext, alphas, can, valid, ilen, tlen,
                                    ll, ybar)
    want_alphas = fused_ctc.ctc_alpha_plain(lp_ext, can, valid, ilen)
    want_grad = fused_ctc.ctc_beta_plain(lp_ext, want_alphas, can, valid,
                                         ilen, tlen, ll, ybar)
    torch.cuda.synchronize()
    assert (fused_ctc.fused_ctc_alpha.launches,
            fused_ctc.fused_ctc_beta.launches) == (n_alpha + 1, n_beta + 1)
    scale = torch.clamp_min(want_alphas.abs(), 1.0)
    assert float(((alphas - want_alphas).abs() / scale).max()) <= CTC_TOL
    assert float((grad - want_grad).abs().max()) <= CTC_TOL
    assert torch.equal(alphas, want_alphas) and torch.equal(grad, want_grad)
    if bsz > 2 and l > 0:
        assert float(ll[2]) < -1e29 and not grad[2].any()
    for row in range(bsz):
        assert not grad[row, max(int(ilen[row]), 0):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,t,l", [(3, 90, 9), (4, 120, 100), (3, 300, 217)])
def test_ctc_kernels_every_plan_matches_plain(bsz, t, l):
    """Every built launch plan that covers the row (positions per thread,
    ring depth) gives the plain versions' alphas and gradient bit for bit."""
    _need_gpu()
    lp_ext, can, valid, ilen, tlen = _ctc_lattice(bsz, t, l, 7 * t, "cuda")
    s = lp_ext.shape[2]
    for items in fused_ctc.PLAN_ITEMS:
        threads = -(-s // (32 * items)) * 32
        if threads > fused_ctc.PLAN_MAX_THREADS:
            continue
        for ring in fused_ctc.PLAN_RINGS:
            plan = (fused_ctc.CTCPlan(items, threads, ring, 0),) * 2
            (alphas, _, grad), (want_alphas, want_grad) = _ctc_pair(
                lp_ext, can, valid, ilen, tlen, plan)
            assert torch.equal(alphas, want_alphas), (items, ring)
            assert torch.equal(grad, want_grad), (items, ring)


@pytest.mark.cuda
def test_ctc_kernel_math_matches_torch_on_every_float():
    """The kernels' own exp and log (CUDA's expf and logf written out so that
    a thread's cells interleave) equal torch.exp bit for bit on every fp32
    bit pattern (NaN for NaN), and torch.log on every finite value >= 1
    (the sums the kernels take the log of)."""
    _need_gpu()
    chunk = 1 << 28
    covered_ge1 = 0
    for start in range(-(1 << 31), 1 << 31, chunk):
        x = torch.arange(start, start + chunk, dtype=torch.int64,
                         device="cuda").to(torch.int32).view(torch.float32)
        ex, lg = fused_ctc.kernel_math_cuda(x)
        ge1 = (x >= 1) & torch.isfinite(x)
        covered_ge1 += int(ge1.sum())
        for got, want in ((ex, torch.exp(x)),
                          (lg[ge1], torch.log(x[ge1]))):
            same = (got.view(torch.int32) == want.view(torch.int32)) | (
                torch.isnan(got) & torch.isnan(want))
            assert bool(same.all()), got[~same][:8].tolist()
    assert covered_ge1 == 0x7f800000 - 0x3f800000


@pytest.mark.cuda
def test_ctc_loss_kernel_route_matches_plain_route():
    """ctc_loss(impl="kernel") through the autograd Function against the
    plain Function on the card: losses and d loss / d log_probs."""
    _need_gpu()
    from vietasr_tpu_torch.ops.ctc_loss import ctc_loss

    rng = np.random.RandomState(11)
    lp = torch.log_softmax(torch.from_numpy(
        rng.randn(6, 80, 9).astype(np.float32)), dim=-1).cuda()
    targets = torch.from_numpy(rng.randint(0, 8, size=(6, 20))).cuda()
    ilen = torch.tensor([80, 77, 60, 41, 80, 9], dtype=torch.int32).cuda()
    tlen = torch.tensor([20, 18, 0, 15, 7, 20], dtype=torch.int32).cuda()
    out = {}
    for plain in (False, True):
        x = lp.clone().requires_grad_(True)
        ext, can, valid = lattice_masks(targets, tlen, 8)
        loss = fused_ctc.ctc_neg_ll(emission_lookup(x, ext), can, valid, ilen,
                                    tlen, plain=plain)
        loss.sum().backward()
        out[plain] = (loss.detach(), x.grad)
    via_loss = ctc_loss(lp, targets, ilen, tlen, blank=8, reduction="none",
                        impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(via_loss, out[False][0])
    assert float((out[False][0] - out[True][0]).abs().max()) \
        <= CTC_TOL * float(out[True][0][:5].abs().max())
    assert float((out[False][1] - out[True][1]).abs().max()) <= 1e-5
