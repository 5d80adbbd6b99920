#!/usr/bin/env python3
"""Time one checkout of the port on one NVIDIA GPU, for A/B comparisons.

    python3 tools/bench_torch_ab.py [--root DIR] [--only GROUPS]

Imports vietasr_tpu_torch from DIR (default: this checkout), so that two
checkouts can be timed on one card in one session; run them in turns (A, B,
B, A). The inputs come from this checkout's chip_smoke.py:
  - the repeat-block kernel alone: the 13 launches of one forward at
    phase 4's shapes (B = 8, T = 840), at phase 4's ragged lengths and at
    full lengths, each launch by `chip_smoke.event_ms` (CUDA events over
    20 calls behind a sleep kernel, after a warm-up);
  - the frontend kernel alone at B = 8 x 16.7 s and B = 32 x 16.7 s (64
    mels, seeded noise x 0.1, ragged lengths with row 0 full), by
    `chip_smoke.event_ms`, with the constants the checkout's own
    featurizer builds (the DFT kernel's packed matrix or the FFT kernel's
    tables);
  - the bf16 frontend kernel alone (fused_frontend="fast") at B = 1 x
    2.0 s (one block per tile: two 128-frame tiles of the wgmma kernel,
    four 64-frame ones of the mma.sync kernel it replaced), B = 8 x 16.7 s
    and B = 32 x 16.7 s, on the same inputs as the frontend kernel, by
    `chip_smoke.event_ms` (`frontend_fast_{B}x{s}s_ms`);
  - the beam kernel alone at its phase-6 timing shape (seeded blank-heavy
    log-probs B = 8, T = 840, V+1 = 91, ragged lengths, W = 100, top-8,
    alpha 0.5, beta 1.5, the word 3-gram chip_smoke.py trains): ms per
    call by `chip_smoke.event_ms`, and us per step
    (the longest row's 840 steps run in series);
  - the beam path: Transcriber(decoder="device_beam") with that word
    3-gram at its default W = 100 over phase 5's 16 seeded signals of
    1.5-16.5 s, audio-s/s by the host clock over 10 calls after a warm-up;
  - the greedy path on the same signals (20 calls), and its forward alone
    on one batch of 8 of them in the 16.7 s bucket (50 calls, ending in a
    synchronise);
  - the CTC kernels alone at phase 7's training shape (B = 32, T = 840,
    S = 435, ragged lengths; chip_smoke.ctc_training_lengths): alpha, and
    beta from those alphas with ybar = 1/32, each by `chip_smoke.event_ms`
    (`ctc_alpha_ms`, `ctc_beta_ms`).
`--only` takes a comma-separated subset of frontend, fast, repeat, beam,
paths and ctc (default: all). Prints one JSON line with the card's name and
power limit.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_seconds(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def frontend_call(np, torch, dev, bsz, seconds, fast=False):
    """A closure that launches this checkout's frontend kernel once on
    seeded inputs, with the constants built as its featurizer builds them:
    `fft_tables` where the checkout has it, else `pack_dft` of the DFT
    matrix; with `fast`, the bf16 kernel with `fast_tables`."""
    from vietasr_tpu_torch.frontend import cuda_frontend as cf
    from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                     _mel_matrix,
                                                     _windowed_dft_matrix,
                                                     feature_seq_len,
                                                     preemphasize_and_pad)

    cfg = FeaturizerConfig(dither=0.0)
    rng = np.random.RandomState(bsz)
    n = int(seconds * cfg.sample_rate)
    sig = torch.from_numpy((rng.randn(bsz, n) * 0.1).astype(np.float32))
    lens = rng.randint(n // 4, n + 1, size=bsz).astype(np.int32)
    lens[0] = n
    xp = preemphasize_and_pad(sig.to(dev), cfg).contiguous()
    seq_len = feature_seq_len(torch.from_numpy(lens).to(dev),
                              cfg.hop_length)
    if fast:
        tables = cf.fast_tables(cfg, dev)
        return lambda: cf.log_mel_tiles_fast_cuda(xp, seq_len, tables,
                                                  cfg=cfg)
    if hasattr(cf, "fft_tables"):
        tables = cf.fft_tables(cfg, dev)
        return lambda: cf.log_mel_tiles_cuda(xp, seq_len, tables, cfg=cfg)
    dft = cf.pack_dft(torch.as_tensor(_windowed_dft_matrix(cfg), device=dev),
                      cfg.fft_length // 2 + 1)
    mel = torch.as_tensor(_mel_matrix(cfg), device=dev)
    return lambda: cf.log_mel_tiles_cuda(xp, seq_len, dft, mel, cfg=cfg)


def ctc_calls(np, torch, dev):
    """Closures that launch this checkout's CTC alpha and beta kernels once
    each at phase 7's training shape."""
    import chip_smoke
    from vietasr_tpu_torch.ops import fused_ctc as fc

    ilen, tlen = chip_smoke.ctc_training_lengths(np)
    c = chip_smoke.ctc_case(np, torch, dev, 8, ilen, tlen, 840)
    lat = (c["lp_ext"], c["can"], c["valid"], c["ilen"])
    alphas = fc.ctc_alpha_cuda(*lat)
    ll = fc.final_ll(alphas[:, -1], c["tlen"])
    beta = (c["lp_ext"], alphas, c["can"], c["valid"], c["ilen"], c["tlen"],
            ll, torch.full_like(ll, 1.0 / 32))
    return (lambda: fc.ctc_alpha_cuda(*lat)), (lambda: fc.ctc_beta_cuda(*beta))


def beam_and_paths(np, torch, dev, only, out):
    """The beam kernel alone ("beam") and the paths a user calls ("paths")
    into `out`."""
    import chip_smoke
    from vietasr_tpu_torch.ops.device_beam import (expansion_width,
                                                   frame_topk,
                                                   init_packed_state,
                                                   word_lm_to_device)
    from vietasr_tpu_torch.ops.fused_beam import beam_search_cuda
    from vietasr_tpu_torch.ops.lm import NGramLM, word_lm_tables
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    with tempfile.TemporaryDirectory() as tmp:
        lm_path = chip_smoke.train_word_lms(tmp)[3]
        beam = Transcriber(chip_smoke.CONFIG, checkpoint=chip_smoke.ANCHOR,
                           options=TranscriberOptions(decoder="device_beam",
                                                      lm_path=lm_path))
        tables, probes = word_lm_tables(NGramLM(lm_path), beam.cfg.labels)
    greedy = Transcriber(chip_smoke.CONFIG, checkpoint=chip_smoke.ANCHOR)

    if "beam" in only:
        # the beam kernel alone
        labels = beam.cfg.labels
        v1 = len(labels) + 1
        lp, lens, _ = chip_smoke.synthetic_beam_inputs(np, torch, dev, v1)
        wl = word_lm_to_device(tables, dev)
        kw = chip_smoke.BEAM_KW
        top_lp, top_ci = frame_topk(lp, expansion_width(v1 - 1,
                                                        kw["cutoff_top_n"]))
        state = init_packed_state(lp.shape[0], 100, wl, dev)

        def kernel():
            beam_search_cuda(lp, lens, top_lp, top_ci, state, blank=v1 - 1,
                             space=labels.index(" "), alpha=kw["alpha"],
                             beta=kw["beta"], word_lm=wl, wlm_probes=probes)

        ms = chip_smoke.event_ms(kernel)
        out["kernel_ms"] = ms
        out["kernel_us_per_step"] = ms / lp.shape[1] * 1e3
    if "paths" in only:
        # the paths a user calls
        signals = chip_smoke.mixed_signals(np)
        audio_s = sum(len(s) for s in signals) / 16000
        dt = host_seconds(torch, lambda: beam.transcribe_batch(signals), 10)
        out["beam_path_audio_s_per_s"] = audio_s / dt
        dt = host_seconds(torch, lambda: greedy.transcribe_batch(signals), 20)
        out["greedy_path_audio_s_per_s"] = audio_s / dt
        full = signals[:8]
        batch = greedy._host_batch(8, greedy.buckets[-1])
        for row, s in enumerate(full):
            batch[row, :len(s)] = s
        flens = np.array([len(s) for s in full], np.int32)
        dt = host_seconds(torch, lambda: greedy._fwd(batch, flens), 50)
        out["greedy_forward_ms"] = dt * 1e3


GROUPS = ("frontend", "fast", "repeat", "beam", "paths", "ctc")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--only", default=",".join(GROUPS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes a subset of {GROUPS}")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, root)
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"root": root}
    if "frontend" in only:
        for bsz in (8, 32):
            out[f"frontend_{bsz}x16.7s_ms"] = chip_smoke.event_ms(
                frontend_call(np, torch, dev, bsz, 16.7))
    if "fast" in only:
        for bsz, seconds in ((1, 2.0), (8, 16.7), (32, 16.7)):
            out[f"frontend_fast_{bsz}x{seconds}s_ms"] = chip_smoke.event_ms(
                frontend_call(np, torch, dev, bsz, seconds, fast=True))
    if "repeat" in only:        # one forward's 13 launches
        for full in (False, True):
            total = 0.0
            for c_in, c_out, k, r, bsz, t, per_fwd in chip_smoke.REPEAT_SHAPES:
                if per_fwd:
                    args = chip_smoke.repeat_inputs(np, torch, dev, c_in,
                                                    c_out, k, r, t, bsz,
                                                    full=full)
                    total += per_fwd * chip_smoke.event_ms(
                        lambda: fused_repeat_block(*args, kernel=k))
            out["repeat_full_lengths_ms" if full else "repeat_ms"] = total
    if "ctc" in only:
        alpha, beta = ctc_calls(np, torch, dev)
        out["ctc_alpha_ms"] = chip_smoke.event_ms(alpha)
        out["ctc_beta_ms"] = chip_smoke.event_ms(beta)
    if only & {"beam", "paths"}:
        beam_and_paths(np, torch, dev, only, out)
    out["card"] = chip_smoke.nvidia_smi_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
