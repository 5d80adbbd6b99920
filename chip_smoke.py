#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vietasr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build   - compile every kernel under vietasr_tpu_torch/csrc with nvcc
  2. device  - the card's name and power limit (nvidia-smi)
  3. frontend kernel vs its plain PyTorch version (2 / 8 / 16.7 s buckets,
     B in {1, 8}, ragged lengths), max |d| < 2e-4
  4. repeat-block kernel vs its plain version at every QuartzNet12x1 block
     shape (T = 840, B = 8, ragged lengths) and at two R > 1 shapes
  5. end to end: Transcriber on the anchor checkpoint in bf16 over 16
     seeded signals of 1.5-16.5 s, with the launch counters read around the
     run; log-probs held against a plain-path Transcriber on the same card
Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Exits non-zero without a GPU or
without the package beside this file.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(HERE, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")

# one NVIDIA H100 SXM (data sheet, dense): fp32 on the CUDA cores, bf16 on
# the tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

FRONTEND_TOL = 2e-4        # the JAX package's own fused-frontend tolerance
# repeat block: bf16 output; one bf16 rounding step at the output's largest
# magnitude is 2^-8 * 2^ceil(log2 max); allow 2^-7 * max|want|, a quarter of
# the JAX test's 0.03 * max|want|
REPEAT_TOL_REL = 2.0 ** -7
# end to end, kernel path vs plain path (bf16): 13 blocks each of whose bf16
# outputs may round one step differently under another fp32 summation order
E2E_LOGP_TOL = 0.25


def device_profile(fn, reps: int = 20):
    """fn() run reps times (after one warm-up) under the CUPTI trace:
    [(ms per call, launches per call, name)] of the kernels and copies it
    ran on the card, largest first. The host ops that launched them carry
    the same time again and are left out, as are CUPTI's own buffer
    requests."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total / reps / 1e3, e.count / reps,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Activity Buffer")),
                  reverse=True)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one fn() call: the summed durations of what it runs
    on the card, so the host's launch gaps between kernels do not count."""
    return sum(r[0] for r in device_profile(fn, reps))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def frontend_phase(np, torch, dev):
    from vietasr_tpu_torch.frontend.cuda_frontend import (
        fused_log_mel_features, fused_log_mel_features_plain,
        log_mel_tiles_cuda, log_mel_tiles_plain, pack_dft)
    from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                     _mel_matrix,
                                                     _windowed_dft_matrix,
                                                     feature_seq_len,
                                                     preemphasize_and_pad)

    cfg = FeaturizerConfig(dither=0.0)
    dft = torch.as_tensor(_windowed_dft_matrix(cfg), device=dev)
    mel = torch.as_tensor(_mel_matrix(cfg), device=dev)
    worst = 0.0
    for seconds in (2.0, 8.0, 16.7):
        for bsz in (1, 8):
            rng = np.random.RandomState(int(seconds * 10) + bsz)
            n = int(seconds * cfg.sample_rate)
            sig = torch.from_numpy(
                (rng.randn(bsz, n) * 0.1).astype(np.float32)).to(dev)
            lens = rng.randint(n // 4, n + 1, size=bsz).astype(np.int32)
            lens[0] = n
            lens = torch.from_numpy(lens).to(dev)
            got, got_len = fused_log_mel_features(sig, lens, cfg=cfg,
                                                  dft_matrix=dft,
                                                  mel_matrix=mel)
            want, want_len = fused_log_mel_features_plain(
                sig, lens, cfg=cfg, dft_matrix=dft, mel_matrix=mel)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()), "frontend: non-finite")
            check(got.shape == want.shape and bool((got_len == want_len)
                                                   .all()),
                  "frontend: shape or seq_len differs from the plain version")
            check(err < FRONTEND_TOL,
                  f"frontend: max|d| {err} >= {FRONTEND_TOL} at B={bsz} "
                  f"{seconds} s")
            worst = max(worst, err)
            print(f"frontend B={bsz} {seconds:>4} s: feats "
                  f"{tuple(got.shape)} max|d| vs plain {err:.3e}")

    # the kernel alone at the main path's largest shape: B = 8, 16.7 s
    bsz, n = 8, int(16.7 * cfg.sample_rate)
    rng = np.random.RandomState(0)
    sig = torch.from_numpy((rng.randn(bsz, n) * 0.1).astype(np.float32)).to(dev)
    lens = torch.from_numpy(rng.randint(n // 2, n + 1, size=bsz)
                            .astype(np.int32)).to(dev)
    xp = preemphasize_and_pad(sig, cfg).contiguous()
    seq_len = feature_seq_len(lens, cfg.hop_length)
    n_fft, nb, n_mels = cfg.fft_length, cfg.fft_length // 2 + 1, cfg.features
    packed = pack_dft(dft, nb)       # once per config, as the featurizer does
    lm_k, parts_k = log_mel_tiles_cuda(xp, seq_len, packed, mel, cfg=cfg)
    lm_p, parts_p = log_mel_tiles_plain(xp, seq_len, dft, mel, cfg=cfg)
    torch.cuda.synchronize()
    tile_err = float((lm_k - lm_p).abs().max())
    check(tile_err < FRONTEND_TOL, f"frontend tiles: max|d| {tile_err}")
    ms = device_ms(lambda: log_mel_tiles_cuda(xp, seq_len, packed, mel,
                                              cfg=cfg))
    plain_ms = device_ms(lambda: log_mel_tiles_plain(xp, seq_len, dft, mel,
                                                     cfg=cfg))
    # the work the function needs: the DFT over the window's nonzero rows
    # only, the mel product over each filter's nonzero taps only
    rows = int(dft.abs().amax(dim=1).count_nonzero())
    mel_taps = int(mel.count_nonzero())
    frames = bsz * lm_k.shape[1]
    flops = frames * (2 * rows * 2 * nb + 3 * nb + 2 * mel_taps
                      + 4 * n_mels)
    nbytes = 4 * (xp.numel() + dft.numel() + mel.numel() + seq_len.numel()
                  + lm_k.numel() + parts_k.numel())
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"frontend kernel B=8 x 16.7 s ({frames} frames): {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
          f"({flops / 1e9:.3f} GFLOP fp32 over {rows} nonzero DFT rows and "
          f"{mel_taps} mel taps, {nbytes / 1e6:.2f} MB)")
    return {"name": "log_mel_frontend", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/frontend.cu",
            "replaces": "vietasr_tpu/frontend/pallas_frontend.py:51",
            "max_abs_err": max(worst, tile_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def repeat_bound_ms(bsz, t, c_in, c_out, k, r, has_res):
    """Least time for one fused block: the larger of its bf16 GEMM work on
    the tensor cores and its fp32 depthwise work on the CUDA cores (the two
    units run side by side), or its bytes."""
    cs = [c_in] + [c_out] * (r - 1)
    gemm = sum(2 * bsz * t * c * c_out for c in cs)
    gemm += 2 * bsz * t * c_in * c_out if has_res else 0
    dw = sum(2 * bsz * t * c * k for c in cs)
    t_ops = max(gemm / PEAK_BF16, dw / PEAK_FP32) * 1e3
    nbytes = (2 * bsz * t * (c_in + c_out) + 4 * bsz
              + sum(4 * k * c + 2 * c * c_out + 4 * c_out for c in cs)
              + ((2 * c_in * c_out + 4 * c_out) if has_res else 0))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def repeat_phase(np, torch, dev):
    from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                    fused_repeat_block_plain)

    # (C_in, C_out, K, R, T, count per forward): the 13 eligible blocks of
    # QuartzNet12x1 at the 16.7 s bucket, then two multi-repeat shapes
    shapes = [(256, 256, 33, 1, 840, 3), (256, 256, 39, 1, 840, 3),
              (256, 512, 51, 1, 840, 1), (512, 512, 51, 1, 840, 2),
              (512, 512, 63, 1, 840, 3), (512, 512, 75, 1, 840, 1),
              (64, 64, 9, 3, 100, 0), (32, 48, 7, 2, 70, 0)]
    bsz = 8
    worst = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bound_by_main = set()
    for c_in, c_out, k, r, t, per_fwd in shapes:
        rng = np.random.RandomState(c_in + c_out + k + r)

        def arr(*shape, scale=1.0, dtype=torch.float32):
            a = (rng.randn(*shape) * scale).astype(np.float32)
            return torch.from_numpy(a).to(dev).to(dtype)

        x = arr(bsz, t, c_in, scale=0.5, dtype=torch.bfloat16)
        lens = rng.randint(t // 4, t + 1, size=bsz).astype(np.int32)
        lens[0] = t
        lens = torch.from_numpy(lens).to(dev)
        cs = [c_in] + [c_out] * (r - 1)
        dws = [arr(k, c, scale=k ** -0.5) for c in cs]
        pws = [arr(c, c_out, scale=c ** -0.5, dtype=torch.bfloat16)
               for c in cs]
        bs = [arr(c_out, scale=0.1) for _ in cs]
        res_w = arr(c_in, c_out, scale=c_in ** -0.5, dtype=torch.bfloat16)
        res_b = arr(c_out, scale=0.1)
        args = (x, lens, dws, pws, bs, res_w, res_b)
        got = fused_repeat_block(*args, kernel=k)
        want = fused_repeat_block_plain(*args, kernel=k)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        check(got.shape == want.shape and got.dtype == torch.bfloat16,
              "repeat: shape or dtype differs from the plain version")
        check(bool(torch.isfinite(got.float()).all()), "repeat: non-finite")
        check(err <= REPEAT_TOL_REL * scale,
              f"repeat ({c_in},{c_out},{k},R={r}): max|d| {err} > "
              f"{REPEAT_TOL_REL} * {scale}")
        worst = max(worst, err)
        ms = device_ms(lambda: fused_repeat_block(*args, kernel=k))
        plain_ms = device_ms(lambda: fused_repeat_block_plain(*args,
                                                              kernel=k))
        bound, bound_by = repeat_bound_ms(bsz, t, c_in, c_out, k, r, True)
        print(f"repeat (C_in {c_in}, C_out {c_out}, K {k}, R {r}) B={bsz} "
              f"T={t}: max|d| {err:.3e} (max|want| {scale:.3f}), "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"by {bound_by}, x{per_fwd} per forward")
        tot["ms"] += per_fwd * ms
        tot["plain_ms"] += per_fwd * plain_ms
        tot["bound_ms"] += per_fwd * bound
        if per_fwd:
            bound_by_main.add(bound_by)
    print(f"repeat kernel, 13 launches of one forward at B=8 x 16.7 s: "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f} ms")
    return {"name": "repeat_block", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/repeat_block.cu",
            "replaces": "vietasr_tpu/ops/pallas_repeat.py:57",
            "max_abs_err": worst, **tot,
            "bound_by": "/".join(sorted(bound_by_main)), "library_ms": None}


def end_to_end_phase(np, torch, dev, kernels):
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.models.convert import load_anchor
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    sr = 16000
    rng = np.random.RandomState(1234)
    # 8 signals fill one B = 8 batch of the 16.7 s bucket; 8 more spread
    # over the shorter buckets
    secs = list(rng.uniform(11.5, 16.5, size=8)) \
        + list(rng.uniform(1.5, 10.5, size=8))
    signals = [(rng.randn(int(s * sr)) * 0.1).astype(np.float32)
               for s in secs]
    audio_s = sum(len(s) for s in signals) / sr

    tr = Transcriber(CONFIG, checkpoint=ANCHOR)
    ref = Transcriber(CONFIG, variables=load_anchor(ANCHOR),
                      options=TranscriberOptions(fused_frontend="off",
                                                 block_impl="plain"))
    check(tr.device.type == "cuda", "Transcriber did not default to CUDA")
    tr.transcribe_batch(signals)                       # warm-up
    groups = {}
    for s in signals:
        groups.setdefault(tr._bucket_len(len(s)), []).append(s)
    forwards = sum(-(-len(g) // tr.opts.max_batch) for g in groups.values())

    fused_log_mel_features.launches = 0
    fused_repeat_block.launches = 0
    texts = tr.transcribe_batch(signals)               # the main path
    launches = {"log_mel_frontend": fused_log_mel_features.launches,
                "repeat_block": fused_repeat_block.launches}
    print(f"main path: {len(signals)} signals, {forwards} forwards, "
          f"launches {launches}")
    check(launches["log_mel_frontend"] == forwards,
          f"frontend kernel launched {launches['log_mel_frontend']} times "
          f"for {forwards} forwards")
    check(launches["repeat_block"] == 13 * forwards,
          f"repeat kernel launched {launches['repeat_block']} times, want "
          f"13 x {forwards}")
    for k in kernels:
        k["launches"] = launches[k["name"]]

    ref_texts = ref.transcribe_batch(signals)
    worst = 0.0
    for s in signals:
        lp, el = tr.log_probs(s)
        lp_ref, el_ref = ref.log_probs(s)
        check(lp.shape == lp_ref.shape and np.isfinite(lp).all(),
              "log-probs: shape or finiteness")
        check(np.array_equal(el, el_ref), "enc_lens differ from the plain path")
        check(np.allclose(np.exp(lp).sum(-1), 1.0, atol=1e-3),
              "log-probs do not normalise")
        worst = max(worst, float(np.abs(lp - lp_ref).max()))
    check(worst <= E2E_LOGP_TOL,
          f"log-probs vs plain path: max|d| {worst} > {E2E_LOGP_TOL}")
    same = sum(a == b for a, b in zip(texts, ref_texts))
    print(f"kernel path vs plain path: max|d log p| {worst:.4e} "
          f"(tol {E2E_LOGP_TOL}), transcripts equal {same}/{len(texts)}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        tr.transcribe_batch(signals)
    dt = (time.perf_counter() - t0) / reps
    print(f"end to end: {audio_s:.1f} audio-s in {dt * 1e3:.2f} ms = "
          f"{audio_s / dt:.1f} audio-s/s (16 signals, {forwards} forwards)")

    # the user call on one full batch of the 16.7 s bucket (8 signals):
    # upload, forward, greedy, transcripts; host clock, results on the host
    full = signals[:8]
    full_s = sum(len(s) for s in full) / sr
    tr.transcribe_batch(full)
    t0 = time.perf_counter()
    for _ in range(20):
        tr.transcribe_batch(full)
    dt = (time.perf_counter() - t0) / 20
    print(f"transcribe_batch B=8 x 16.7 s bucket: {dt * 1e3:.3f} ms = "
          f"{full_s / dt:.1f} audio-s/s")
    batch = tr._host_batch(8, tr.buckets[-1])
    lens = np.array([len(s) for s in full], np.int32)
    for row, s in enumerate(full):
        batch[row, :len(s)] = s
    # the forward alone (upload, frontend, encoder, head, greedy on the card)
    tr._fwd(batch, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        tr._fwd(batch, lens)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 20
    print(f"forward B=8 x 16.7 s bucket: {dt * 1e3:.3f} ms = "
          f"{full_s / dt:.1f} audio-s/s")

    # where the forward's device time goes (CUPTI trace of 20 forwards)
    rows = device_profile(lambda: tr._fwd(batch, lens))
    busy_ms = sum(r[0] for r in rows)
    print(f"profile of one forward (B=8 x 16.7 s): device busy "
          f"{busy_ms:.4f} ms of {dt * 1e3:.4f} ms wall ("
          f"{100 * (1 - busy_ms / (dt * 1e3)):.1f} % idle)")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.4f} ms  x{count:<4g} {key[:100]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vietasr_tpu_torch")):
        print("chip_smoke: the vietasr_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vietasr_tpu_torch import _build

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    dev = torch.device("cuda")
    kernels = [frontend_phase(np, torch, dev), repeat_phase(np, torch, dev)]
    end_to_end_phase(np, torch, dev, kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
