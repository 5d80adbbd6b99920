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
     run; log-probs held against a plain-path Transcriber on the same card.
     Then the beam tier on the same signals: Transcriber(decoder=
     "device_beam") at its default W = 100 with a word 3-gram trained on
     the repo's text, one beam launch per forward, transcripts held against
     the plain device_beam_search on the same log-probs
  6. beam kernel vs its plain version (device_beam_search) on seeded
     synthetic log-probs (B = 8, T = 840, ragged) and on the anchor's
     posteriors of phase 5's signals, word 3-gram and 5-gram at W in
     {16, 50, 100} and no LM at W = 16, cutoff 8, alpha 0.5, beta 1.5:
     ids identical at W = 16, transcripts identical on the anchor
     posteriors, and any other row that differs within 1e-4 |total| of the
     plain final best total
Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Exits non-zero without a GPU or
without the package beside this file.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(HERE, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")
MANIFEST = os.path.join(HERE, "artifacts", "real_speech_manifest.json")
# the benchmark's small Vietnamese corpus (every char in the labels); the
# word LMs are trained on it plus the manifest's transcripts
VI_CORPUS = [
    "xin chào các bạn", "bản tin thời sự hôm nay", "chào mừng quý vị",
    "tin tức trong ngày", "cảm ơn các bạn đã lắng nghe",
    "thời tiết hà nội hôm nay", "chúc các bạn một ngày tốt lành",
    "đây là đài tiếng nói việt nam", "tin thể thao quốc tế",
    "giá xăng dầu trong nước", "tình hình giao thông buổi sáng",
    "xin kính chào quý vị và các bạn", "bản tin cuối ngày",
    "chương trình ca nhạc theo yêu cầu", "dự báo thời tiết ngày mai",
] * 2

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
# beam search on synthetic logits at W = 50 / 100: a row whose decode
# differs from the plain version's (fp ties under another summation order)
# must still reach the same final best total to this relative tolerance
BEAM_TOTAL_REL_TOL = 1e-4
BEAM_KW = dict(cutoff_top_n=8, alpha=0.5, beta=1.5)


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
    return signals


def train_word_lms(tmpdir):
    """Word 3- and 5-gram ARPA files over VI_CORPUS + the manifest texts."""
    from vietasr_tpu_torch.ops.lm import train_ngram_arpa

    with open(MANIFEST, encoding="utf-8") as f:
        refs = [json.loads(line)["text"].strip() for line in f]
    paths = {}
    for order in (3, 5):
        paths[order] = os.path.join(tmpdir, f"vi_word{order}.arpa")
        train_ngram_arpa(VI_CORPUS + refs, paths[order], order=order)
    return paths


def forward_batches(np, torch, tr, signals):
    """The forwards transcribe_batch makes for `signals`, in its order:
    [(signal indices, log_probs on the card, enc_lens)]."""
    order = sorted(range(len(signals)), key=lambda i: len(signals[i]))
    out, i = [], 0
    while i < len(order):
        bl = tr._bucket_len(len(signals[order[i]]))
        group = []
        while (i < len(order) and len(group) < tr.opts.max_batch
               and tr._bucket_len(len(signals[order[i]])) == bl):
            group.append(order[i])
            i += 1
        batch = tr._host_batch(len(group), bl)
        lens = np.array([len(signals[g]) for g in group], np.int32)
        for row, g in enumerate(group):
            batch[row, :len(signals[g])] = signals[g]
        lp, el, _, _ = tr._fwd(batch, lens)
        torch.cuda.synchronize()      # the page-locked batch is refilled next
        out.append((group, lp, el))
    return out


def render(labels, ids, lens):
    ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
    return [" ".join("".join(labels[i] for i in ids[b, :lens[b]]).split())
            for b in range(ids.shape[0])]


def beam_path_phase(np, torch, signals, lm_paths, kernels):
    """The beam tier end to end: Transcriber(decoder="device_beam") at its
    default width with the word 3-gram, counters read around the run."""
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.ops.device_beam import device_beam_search
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    tr = Transcriber(CONFIG, checkpoint=ANCHOR, options=TranscriberOptions(
        decoder="device_beam", lm_path=lm_paths[3]))
    check(tr._device_word_lm is not None, "the word LM was not sniffed")
    labels = tr.cfg.labels
    width = tr.opts.beam_width
    tr.transcribe_batch(signals)                       # warm-up
    batches = forward_batches(np, torch, tr, signals)
    forwards = len(batches)

    fused_log_mel_features.launches = 0
    fused_repeat_block.launches = 0
    fused_beam_search.launches = 0
    texts = tr.transcribe_batch(signals)               # the beam path
    launches = {"log_mel_frontend": fused_log_mel_features.launches,
                "repeat_block": fused_repeat_block.launches,
                "beam_search": fused_beam_search.launches}
    print(f"beam path (W={width}, word 3-gram): {len(signals)} signals, "
          f"{forwards} forwards, launches {launches}")
    check(launches == {"log_mel_frontend": forwards,
                       "repeat_block": 13 * forwards,
                       "beam_search": forwards},
          f"beam path launches {launches} for {forwards} forwards")
    for k in kernels:
        if k["name"] == "beam_search":
            k["launches"] = launches["beam_search"]

    # the same log-probs through the plain device_beam_search
    plain = [None] * len(signals)
    for group, lp, el in batches:
        ids, n = device_beam_search(
            lp, el, blank=len(labels), beam_width=width,
            word_lm=tr._device_word_lm, wlm_probes=tr._device_wlm_probes,
            space=labels.index(" "), **BEAM_KW)
        for row, text in zip(group, render(labels, ids, n)):
            plain[row] = text
    same = sum(a == b for a, b in zip(texts, plain))
    print(f"beam path vs plain device_beam_search: transcripts equal "
          f"{same}/{len(texts)}")
    check(same == len(texts), "beam transcripts differ from the plain "
          "device_beam_search on the same log-probs")

    audio_s = sum(len(s) for s in signals) / 16000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        tr.transcribe_batch(signals)
    dt = (time.perf_counter() - t0) / reps
    print(f"beam path end to end: {audio_s:.1f} audio-s in {dt * 1e3:.2f} ms "
          f"= {audio_s / dt:.1f} audio-s/s")
    rows = device_profile(lambda: tr.transcribe_batch(signals), reps=3)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile of the beam path (16 signals): device busy "
          f"{busy_ms:.4f} ms of {dt * 1e3:.4f} ms wall ("
          f"{100 * (1 - busy_ms / (dt * 1e3)):.1f} % idle)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.4f} ms  x{count:<4g} {key[:100]}")
    # the anchor's posteriors of these signals as one (16, T, V+1) batch;
    # frames past a row's length are never read
    t_max = max(lp.shape[1] for _, lp, _ in batches)
    anchor_lp = torch.zeros((len(signals), t_max, len(labels) + 1),
                            device=batches[0][1].device)
    anchor_lens = torch.zeros((len(signals),), dtype=torch.int32,
                              device=anchor_lp.device)
    for group, lp, el in batches:
        for row, g in enumerate(group):
            anchor_lp[g, :lp.shape[1]] = lp[row]
            anchor_lens[g] = el[row]
    return labels, anchor_lp, anchor_lens


def beam_bound_ms(lens, t_max, v1, k_c, w, n_cols, lm_rows, levels, probes):
    """Least time for the beam search on these inputs: the larger of its
    bytes (log-probs and top-K in, start state in, backpointers and final
    state out, the LM table once) at 3.35 TB/s and its operations at the
    fp32 rate, counted per valid frame of each row: expand ~6 per
    candidate (base select, add, two hash multiply-adds), the merge test 6
    per (stay, parent) pair (two hash multiply-adds, two compares), ~16 per
    beam for its stay terms, ~(8 + 3 probes) per LM chain, a top-W select
    of log2(W) compares per candidate, ~20 per new slot."""
    import math

    bsz = int(lens.shape[0])
    steps = int(lens.sum())
    nbytes = (4 * bsz * t_max * v1 + 8 * bsz * t_max * k_c
              + 8 * t_max * bsz * w + 2 * 4 * bsz * w * n_cols
              + 16 * lm_rows + 16 * levels + 4 * bsz)
    per_step = (6 * w * k_c + 6 * w * w + 16 * w
                + w * levels * (8 + 3 * probes)
                + w * (k_c + 1) * math.ceil(math.log2(max(w, 2))) + 20 * w)
    t_ops = steps * per_step / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), steps * per_step, nbytes


def beam_phase(np, torch, dev, labels, anchor_lp, anchor_lens, lm_paths):
    from vietasr_tpu_torch.ops.device_beam import (best_path_from_raw,
                                                   device_beam_search,
                                                   expansion_width,
                                                   frame_topk,
                                                   init_packed_state,
                                                   packed_beam_totals,
                                                   word_lm_to_device)
    from vietasr_tpu_torch.ops.fused_beam import (beam_search_cuda,
                                                  fused_beam_search)
    from vietasr_tpu_torch.ops.lm import NGramLM, word_lm_tables

    tables = {}
    for order, path in lm_paths.items():
        t, probes = word_lm_tables(NGramLM(path), labels)
        tables[order] = (word_lm_to_device(t, dev), probes)
    v1, space = len(labels) + 1, labels.index(" ")
    bsz, t_max = 8, 840
    rng = np.random.RandomState(2024)
    logits = rng.randn(bsz, t_max, v1).astype(np.float32) * 3.0
    logits[:, :, v1 - 1] += 2.0                       # blank-heavy, as CTC
    synth_lp = torch.log_softmax(torch.from_numpy(logits), -1).to(dev)
    synth_lens = rng.randint(t_max // 2, t_max + 1, size=bsz).astype(np.int32)
    synth_lens[0] = t_max
    synth_lens = torch.from_numpy(synth_lens).to(dev)
    inputs = {"synthetic": (synth_lp, synth_lens),
              "anchor": (anchor_lp, anchor_lens)}

    worst = 0.0
    for order, w in [(None, 16)] + [(o, w) for o in (3, 5)
                                    for w in (16, 50, 100)]:
        wl, probes = tables[order] if order else (None, 8)
        kw = dict(beam_width=w, space=space, word_lm=wl, wlm_probes=probes,
                  **BEAM_KW)
        fin = dict(word_lm=wl, alpha=BEAM_KW["alpha"], beta=BEAM_KW["beta"],
                   wlm_probes=probes)
        for name, (lp, lens) in inputs.items():
            raw_k = fused_beam_search(lp, lens, blank=v1 - 1,
                                      return_raw=True, **kw)
            raw_p = device_beam_search(lp, lens, blank=v1 - 1,
                                       return_raw=True, **kw)
            torch.cuda.synchronize()
            raw_equal = all(torch.equal(a, b) for a, b in zip(raw_k, raw_p))
            ids_k, n_k = best_path_from_raw(*raw_k, **fin)
            ids_p, n_p = best_path_from_raw(*raw_p, **fin)
            best_k = packed_beam_totals(raw_k[0], **fin).amax(dim=1)
            best_p = packed_beam_totals(raw_p[0], **fin).amax(dim=1)
            err = (best_k - best_p).abs()
            check(bool(torch.isfinite(best_k).all()), "beam: non-finite")
            differ = [b for b in range(lp.shape[0])
                      if int(n_k[b]) != int(n_p[b])
                      or not torch.equal(ids_k[b, :int(n_k[b])],
                                         ids_p[b, :int(n_p[b])])]
            texts_equal = render(labels, ids_k, n_k) == render(labels, ids_p,
                                                               n_p)
            worst = max(worst, float(err.max()))
            print(f"beam {name} B={lp.shape[0]} W={w} LM "
                  f"{order or 'none'}: raw state/backpointers equal "
                  f"{raw_equal}, rows differing {len(differ)}, max |d best "
                  f"total| {float(err.max()):.3e}")
            where = f"beam {name} W={w} LM {order}"
            check(w != 16 or not differ, f"{where}: ids differ in rows "
                  f"{differ}")
            check(name != "anchor" or texts_equal,
                  f"{where}: transcripts differ")
            for b in differ:
                check(float(err[b]) <= BEAM_TOTAL_REL_TOL
                      * abs(float(best_p[b])),
                      f"{where}: row {b} best total {float(best_k[b])} vs "
                      f"{float(best_p[b])}")

    # times at the bound's shape: B = 8, T = 840, W = 100, word 3-gram
    wl, probes = tables[3]
    w = 100
    k_c = expansion_width(v1 - 1, BEAM_KW["cutoff_top_n"])
    top_lp, top_ci = frame_topk(synth_lp, k_c)
    state = init_packed_state(bsz, w, wl, dev)
    kern = dict(blank=v1 - 1, space=space, alpha=BEAM_KW["alpha"],
                beta=BEAM_KW["beta"], word_lm=wl, wlm_probes=probes)
    ms = device_ms(lambda: beam_search_cuda(synth_lp, synth_lens, top_lp,
                                            top_ci, state, **kern), reps=10)
    plain = dict(beam_width=w, space=space, word_lm=wl, wlm_probes=probes,
                 return_raw=True, **BEAM_KW)
    plain_ms = device_ms(lambda: device_beam_search(
        synth_lp, synth_lens, blank=v1 - 1, **plain), reps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device_beam_search(synth_lp, synth_lens, blank=v1 - 1, **plain)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    bound, bound_by, ops, nbytes = beam_bound_ms(
        synth_lens, t_max, v1, k_c, w, state.shape[-1], wl.packed.shape[0],
        int(wl.masks.shape[0]), probes)
    print(f"beam kernel B={bsz} T={t_max} W={w} K={k_c} word 3-gram "
          f"({wl.packed.shape[0]} table rows, {probes} probes): {ms:.4f} ms "
          f"({ms / t_max * 1e3:.2f} us per step), plain {plain_ms:.4f} ms "
          f"device ({plain_wall:.1f} ms wall), bound {bound:.4f} ms by "
          f"{bound_by} ({ops / 1e9:.3f} G operations, {nbytes / 1e6:.2f} "
          f"MB); the {t_max} steps run one after another")
    return {"name": "beam_search", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/beam_search.cu",
            "replaces": "vietasr_tpu/ops/pallas_beam.py:325",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


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
    signals = end_to_end_phase(np, torch, dev, kernels)
    with tempfile.TemporaryDirectory() as tmp:
        lm_paths = train_word_lms(tmp)
        kernels.append({"name": "beam_search", "launches": 0})
        labels, anchor_lp, anchor_lens = beam_path_phase(
            np, torch, signals, lm_paths, kernels)
        kernels[-1].update(beam_phase(np, torch, dev, labels, anchor_lp,
                                      anchor_lens, lm_paths))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
