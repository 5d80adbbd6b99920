#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vietasr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build   - compile every kernel under vietasr_tpu_torch/csrc with nvcc,
     and the host beam tier's C++ library (native/ctc_beam.cc) with g++
  2. device  - the card's name and power limit (nvidia-smi)
  3. frontend kernel (an FFT per frame) vs its plain PyTorch version
     (frames @ DFT matrix) at B in {1, 8} x {2, 8, 16.7} s and B = 32 x
     16.7 s, 64 and 80 mels, ragged lengths with row 0 full: features
     within 2e-4 with equal seq_len, the log-mel no further from an fp64
     chain than the plain chain is, partials within 1e-5 of their largest;
     the kernel's ms per shape, its bound (bytes vs a real FFT's
     operations), the DFT-count bound, the plain version's ms and the
     torch.stft + |X|^2 + mel + log composition's ms
  3b. the bf16 frontend kernel (fused_frontend="fast", frames @ DFT on
     wgmma and power @ mel on mma.sync) vs its plain PyTorch version at
     phase 3's 14 shapes, at the largest hop its launch plan takes with 64
     mels (512: 64-frame blocks) and at B = 3 with rows ending inside a
     128-frame block, each shape's plan printed (frames a block, ring
     stages, DFT columns a stage, shared memory, blocks launched): the
     log-mel in the mel-power domain within 2^-7 of each
     frame's largest mel power, equal seq_len, partials within 1e-5 of the
     largest of those summed from its own log-mel; p50/p99/max |d log-mel|
     from the fp64 chain for the bf16 kernel, its plain version and the
     fp32 kernel; ms at every shape, the bound (bf16 operations vs bytes),
     and at B = 8 and 32 x 16.7 s the plain version's ms and a bf16
     torch.matmul composition's ms
  4. repeat-block kernel vs its plain version at every QuartzNet12x1 block
     shape (T = 840, B = 8), at the 512-wide block shapes of phase 5's
     small forwards (B = 2 x T = 304, B = 4 x T = 408, B = 2 x T = 552)
     and at two R > 1 shapes, at ragged and at full lengths: the rows per
     block and column groups each launch chose, the blocks it skipped as
     padding, its time; the library composition (cuDNN depthwise, two
     cuBLAS bf16 matmuls) printed beside it as composition_ms. R > 1
     blocks take the whole-block kernel (csrc/repeat_whole_block.cu, one
     launch a block over a cluster of up to 8 blocks): at QuartzNet15x5's
     six R = 5 shapes (B = 8, T = 840), ragged and full lengths, it is
     held to the plain version and timed beside the bound and the chain
     of 5 one-repeat launches (a yardstick, held too), each launch's plan
     printed (tile rows, cluster, blocks, skipped as padding, shared
     memory, clusters the card holds at once)
  5. end to end: Transcriber on the anchor checkpoint in bf16 over 16
     seeded signals of 1.5-16.5 s, with the launch counters read around the
     run; log-probs held against a plain-path Transcriber on the same card.
     Then the beam tier on the same signals: Transcriber(decoder=
     "device_beam") at its default W = 100 with a word 3-gram trained on
     the repo's text, one beam launch per transcribe_batch call (every
     forward's rows in one decode), transcripts held against the plain
     device_beam_search on the same log-probs, and equal when the LM comes
     from its KenLM PROBING binary
  5c. the main path's last two options over phase 5's 16 signals:
     Transcriber(fused_frontend="fast"), 1 bf16-frontend launch per
     forward and none of the fp64 FFT kernel, frame argmax and
     transcripts against the default route, audio-s/s and idle share;
     then calibrate_int8 on the same signals: 28 int8 sites, no
     repeat-block launch (every block per-op), argmax against the bf16
     float route, audio-s/s and idle share, and at every site's shape of
     the B = 8 x 16.7 s forward the int8 GEMM (torch._int_mm) equal bit
     for bit to the exact GEMM (fp32 products of the int8 values)
  6. beam kernel vs its plain version (device_beam_search) on seeded
     synthetic log-probs (B = 8, T = 840, ragged) and on the anchor's
     posteriors of phase 5's signals, word 3-gram and 5-gram at W in
     {16, 50, 100} and no LM at W = 16, and on tie-heavy log-probs (the
     synthetic logits rounded to multiples of 0.25) at W = 100 with the
     word 3-gram; cutoff 8, alpha 0.5, beta 1.5: the raw result (final
     state and backpointers) equal bit for bit in every case; the kernel's
     time, microseconds and barriers per step at B = 8, T = 840, W = 100
  6b. the host beam path (the reference's infer.py decoder):
     Transcriber(decoder="beam") at W = 100, alpha 0.5, beta 1.5 with the
     word 3-gram from its PROBING binary over phase 5's 16 signals, the
     launch counters read around the run (1 frontend and 13 repeat-block
     launches per forward, no beam-kernel launch); transcripts equal the
     C++ tier's on the same log-probs from the ARPA and from the TRIE
     binary, and on the 4 shortest signals at W = 16 the Python tier's;
     audio-s/s, device busy and idle share, the host decode's ms per call
     beside the forwards'; a Transcriber built from the reference's two
     NeMo .pt files (written from the anchor) gives the anchor's
     log-probs; transcribe_file of a PCM16 and an 8 kHz mu-law WAV gives
     transcribe's text of the samples read_audio returns
  7. CTC alpha and beta kernels vs their plain versions: the training
     shape (B = 32, T = 840 encoder frames, ragged lengths, ~13 characters
     per second of audio: S = 435) and edge cases (target length 0, an
     infeasible row, repeated labels, B = 1, S = 1025, T = 1, T = 3 below
     the prefetch ring's depth, input lengths 0 and 1, S = 1, S = 4095);
     losses, alphas and gradients within CTC_TOL and, counted, 0 elements
     differing from the plain versions; the launch plan of each shape; the
     loss also against F.ctc_loss, which times the library's CTC
  8. the training path end to end: Trainer on QuartzNet12x1_vi at full
     width (init_quartznet, seed 0), bf16, Novograd lr 0.02, wd 0.001,
     CosineAnnealing with a 5-step warmup over 30 steps, B = 32 seeded
     signals of 1.5-16.7 s padded to the 16.7 s bucket with VI_CORPUS
     transcripts; one CTC kernel launch each way per step, 0 skipped
     steps, the loss below 0.7x its first value after 30 steps on one
     batch, and 3 steps through the kernels == 3 through the plain CTC
  9. long-form (after 6b): Transcriber.transcribe_long_batch (greedy,
     bf16) over seeded noise of 45, 90, 180 and 300 s at 16 kHz float32,
     300 s of 8 kHz int16 and 120 s of 8 kHz mu-law, uploaded in their
     wire dtype and decoded and resampled on the card (93 chunks of 15 s;
     1 frontend and 13 repeat launches per utterance, counted); the
     stitched log-probs against the plain route (frontend and repeat
     plain) on the card, frame argmax agreement >= 0.99 and max|d log p|
     within E2E_LOGP_TOL; the device int16 / G.711 decode and 8 -> 16 kHz
     resampler against the host path within 1e-5, with cuDNN's TF32 flag
     off and at PyTorch's default; the repeat kernel at the 300 s batch
     (B = 27 x T = 752) against its plain version; audio-s/s and idle
     share; transcribe_long with decoder="device_beam" (W = 100, the word
     3-gram; 1 beam launch) on 90 s, and the beam kernel against the plain
     search on the 45 s signal's stitched log-probs, raw result bit for
     bit; the host beam (decoder="beam", PROBING) on 90 s
  10. streaming serving: OnlineTranscriber on the causal anchor
     (quartznet12x1_vi_causal.yaml) in fp32 over 20 s in 3200-sample
     chunks with a mid-chunk end, against an fp64 offline forward on the
     card (no further, in p and log p, than 2x the fp32 offline forward
     on the same input), and on a narrow model with no
     normalization against the fp32 offline forward (1e-4 in log p); two
     StreamPool(slots=8, decoder="beam", W = 16, cutoff 8, word 3-gram)
     over 8 staggered mu-law streams of 5-20 s in lockstep, one on the
     beam kernel with the carried state and one on the plain search:
     their carried beam states equal bit for bit after every step, their
     pieces and final texts equal, 1 beam launch per tick; ms per tick;
     then AsrServer on an ephemeral port: /upload of a 3 s and a 40 s WAV
     equal to Transcriber.transcribe / transcribe_long of the samples
  11. the Conformer-CTC family. (a) Transcriber on conformer_ctc_vi.yaml
     at full width (16 blocks, d 256, 27,346,779 parameters, seeded
     init_conformer), bf16, over phase 5's 16 signals: 1 frontend kernel
     launch per forward and no repeat, beam or CTC launch; log-probs
     against the plain frontend on the card (frame argmax >= 0.99, max
     |d log p| printed) and against the fp32 forward (argmax printed);
     audio-s/s and idle share; the B = 8 x 16.7 s forward's device time
     by group (GEMMs, attention elementwise + softmax, depthwise conv,
     conv2d subsampling, LayerNorm / GLU / swish elementwise, frontend,
     uploads); decoder="device_beam" at W = 100 with the word 3-gram: 1
     beam launch per transcribe_batch call, the raw result bit for bit
     with the plain device_beam_search on the same log-probs, texts
     equal; decoder="beam" from the PROBING binary on the 4 shortest
     signals, texts equal to the C++ tier over the ARPA (long-form on a
     Conformer: phase 13d). (b) conformer_ctc_vi_streaming.yaml at full width
     (25,525,339 parameters), fp32: ConformerOnlineTranscriber over
     20.48 s of noise against the offline chunked forward of the frames
     it saw (2e-4 in log p); two StreamPool(slots=8, decoder="beam",
     W = 16, word 3-gram) over 8 staggered mu-law streams of 5-20 s in
     0.64 s chunks, one on the beam kernel and one on the plain search:
     carried states bit for bit after every tick, texts equal, 1 beam
     launch a tick; ms per tick. The kernel lines' path_launches gain
     conformer_greedy, conformer_device_beam and
     conformer_stream_pool_beam
  12. training from a manifest through the command line (after 8). (a)
     64 seeded PCM16 WAVs of 1.5-16.7 s with VI_CORPUS transcripts and a
     manifest; `cli.main(["train", ...])` in process on
     quartznet12x1_vi.yaml, bf16, B = 32, Novograd, --augment
     speed,gain,noise,shift, warmup 2, one epoch (8 steps, one per
     duration bucket): 1 frontend, 1 alpha, 1 beta launch a step, no
     repeat launch, 0 skipped steps, finite losses, a checkpoint; a
     second call resumes from it (traced: device busy vs the steps'
     wall); the BucketBatcher alone, batches/s. (b) `eval` from the
     checkpoint equal to Trainer.evaluate; `transcribe` (greedy and
     device_beam) over 16 eval WAVs equal to the Transcriber's texts, 1
     frontend and 13 repeat launches a forward, 1 beam launch a call.
     (c) Jasper10x5dr at full width built in code (params beside the
     paper's ~333 M): the B = 8 x 16.7 s bf16 forward with BN folded vs
     its fp32 forward (argmax, |d log p| <= E2E_LOGP_TOL), 0 repeat
     launches, wall, busy by group, idle; 3 LAMB Trainer steps at B = 8.
     (d) conformer_ctc_vi at full width: 3 steps at B = 16 with dropout,
     remat off and on (ms a step, peak memory, the CTC pair once a step);
     with dropout 0 the gradients with and without remat within
     REMAT_GRAD_RTOL. path_launches gain cli_train, cli_eval,
     cli_transcribe, cli_transcribe_device_beam, jasper_train and
     conformer_train
  13. parallelism, export and long-form on a Conformer (after 12). (a) 2
     gloo ranks spawned on the one card (NCCL refuses two ranks on one
     device): QuartzNet12x1_vi at full width, bf16, 3 data-parallel
     steps on 16 + 16 of phase 8's 32 rows (dither and SpecAugment off):
     the ranks' params and BN stats bit for bit, within phase 8's bf16
     bars of the one-process step on the 32 rows, 1 frontend, 1 alpha, 1
     beta launch a step a rank, each held to its plain version on the
     rank's batch; then a world-size-1 NCCL group: the same 3 steps
     against the one-process step, the gradient all-reduce's ms, ms a
     step with and without the group beside phase 8's. (b) the same
     ranks run conformer_ctc_vi in fp32 tensor-parallel (heads and FFN
     columns over 2 ranks), B = 8 x 16.7 s: within TP_TOL of the
     replicated forward. (c) export_transcriber of the anchor's
     Transcriber at B = 1 and 8 x 16.7 s, loaded back: outputs bit for
     bit with the eager forward, 1 frontend and 13 repeat launches a
     forward of the loaded program; ms a forward of the loaded program,
     the eager forward, and the eager forward through the custom ops.
     (d) transcribe_long on conformer_ctc_vi over 45-300 s: stitched
     frames equal the offline forward's grid, audio-s/s and idle share,
     1 frontend launch a call; device_beam (W = 100, word 3-gram) on 90
     s, 1 beam launch, the beam kernel bit for bit with the plain search
     on the 45 s posterior. path_launches gain dp_train, dp_train_nccl1,
     tp_forward, export_forward and conformer_longform
  14. the rest of the JAX package (after 13), on the anchor in bf16 with
     BN folded. (a) Kaldi features into CTC: phase 5's 16 signals
     featurized in one padded batch (1 frontend launch), written as an FM
     ark + scp and a CM ark with a `text` of VI_CORPUS lines, read back
     through KaldiFeatureDataset, padded to the in-memory frames and
     forwarded (13 repeat launches, each held to its plain version on
     this batch), decoded by greedy_transcripts: the FM round trip and
     its log-probs bit for bit with the in-memory forward, the CM decode
     error within half a code step of each column's widest segment plus
     the header's fp32 rounding, the CM path's argmax agreement with the
     FM path, ms of each read and of the forward, audio-s/s. (b) speech
     classification: 64 seeded 1 s PCM16 clips with Speech Commands v2's
     35 labels through AudioLabelDataset into one B = 64 batch, the
     log-mel (1 frontend launch), crop_or_pad_spectrogram to 128 frames,
     the anchor's encoder output through the pw_fn hook (per-op blocks: 0
     repeat launches), the classifier head 1024 -> 35 (seed 0) with avg
     and max pooling, cross entropy, top-1 / top-5 accuracy: bf16 logits
     vs the fp32 path (max |d|, argmax agreement), ms a batch. (c) LAS at
     width 512 on phase 5's B = 8 x 16.7 s batch (1 frontend launch, the
     encoder output through the pw_fn hook): the connector 1024 -> 512,
     a GRU encoder and the attention decoder (vocab 93), seed 0;
     greedy_generate and beam_generate (W = 8, 200 steps), las_evaluate
     against VI_CORPUS; in fp32 the teacher-forced log-probs within 1e-4
     of the same call on the CPU and the greedy tokens against the CPU's
     (the first divergence printed); ms a generator and a step. (d) the
     seq2seq copy task trained on the card: loss < 0.3, greedy and beam
     accuracy > 0.8. (e) the spectrogram and MFCCs (64) on phase 5's B =
     8 x 16.7 s batch vs the same calls on the CPU (power within 1e-5 of
     each frame's largest, features within 2e-4 on bins >= 1e-6 of it,
     MFCCs within 2e-4; the power of each within 1e-5 of an fp64 chain's,
     the log power's distance from it printed), ms beside the frontend
     kernel's log-mel. Each path's
     launches of all seven kernels are counted (0 where not named):
     path_launches gain kaldi_ctc, classify and las
  15. QuartzNet15x5 at full width (after 11): its YAML written into a
     temporary directory (quartznet12x1_vi.yaml's sections with the
     encoder of the QuartzNet paper's Table 1: C1 k33 s2, B1-B5 x 3
     blocks of R = 5 at k 33-75, C2 k87 dilation 2, C3 k1 1024), the
     Transcriber's seeded init (BN folded, bf16) over phase 5's 16
     signals: greedy, 1 frontend and 15 whole-block launches a forward and
     no one-repeat launch, every whole-block launch held to its plain
     version on its own inputs, log-probs within E2E_LOGP_TOL of the
     plain route, audio-s/s and idle share, then the same with the
     R-launch chain patched in for the whole-block kernel (a yardstick,
     75 one-repeat launches a forward); R = 5 blocks the whole-block plan
     cannot take (16 -> 512, 512 -> 1024) run per op with no repeat
     launch; decoder="device_beam" at W = 100 with the word 3-gram, 1
     beam launch a call, the raw result bit for bit with the plain
     search. path_launches gain qn15x5_greedy and qn15x5_device_beam
Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Exits non-zero without a GPU or
without the package beside this file.
"""

import contextlib
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
# frontend partials (per-tile sums of up to 16 log-mel values and their
# squares) vs the plain version's, relative to the largest: fp32 sums of the
# same terms in another order
FRONTEND_PARTS_RTOL = 1e-5
# repeat block: bf16 output; one bf16 rounding step at the output's largest
# magnitude is 2^-8 * 2^ceil(log2 max); allow 2^-7 * max|want|, a quarter of
# the JAX test's 0.03 * max|want|
REPEAT_TOL_REL = 2.0 ** -7
# bf16 frontend kernel vs its plain version, in the mel-power domain
# relative to each frame's largest mel power: the two differ only in the
# order of fp32 sums, which can flip the bf16 rounding of a power term; one
# flip moves a mel by at most one bf16 step of that term, 2^-7 of the mel
FAST_MEL_TOL = 2.0 ** -7
# end to end, fused_frontend="fast" vs the default route and int8 vs the
# bf16 float route: frame argmax agreement (the CPU tests' bar vs JAX)
FAST_ARGMAX_MIN = 0.95
INT8_ARGMAX_MIN = 0.95
# end to end, kernel path vs plain path (bf16): 13 blocks each of whose bf16
# outputs may round one step differently under another fp32 summation order
E2E_LOGP_TOL = 0.25
BEAM_KW = dict(cutoff_top_n=8, alpha=0.5, beta=1.5)
# CTC pair vs its plain version: the same fp32 formulas in the same order
# with the same expf/logf (the exps the kernels skip are exactly 1, or add
# less than half an ulp), so alphas, losses and gradients agree bit for
# bit, which phase 7 counts; CTC_TOL (relative for alphas and losses,
# absolute for the gradient, whose entries lie in [0, ybar]) is the bound
# printed beside it
CTC_TOL = 1e-6
# the port's loss vs F.ctc_loss: another algorithm (its own lattice and
# summation order) over up to 840 dependent fp32 steps
CTC_LIBRARY_RTOL = 1e-4
# the kernels' gradient vs autodiff through an fp64 scan, relative to the
# largest |gradient|: the analytic gradient exp(alpha + beta - ll) (the
# Pallas kernels' formula) takes the difference of lattice values ~1.6e3
# that each carry the rounding of up to 840 fp32 additions (~1e-3), so its
# entries are only ~1e-3 relatively right; autodiff through the scan is
# closer, since each step's softmax weights come from nearby values
CTC_GRAD_FP64_RTOL = 1e-2
# operations per lattice cell: lse3 (2 max, 3 sub, 3 exp, 2 add, log, add,
# compare) + the emission add + a select; the backward also forms the
# gradient (add, sub, min, exp, mul, select)
CTC_ALPHA_OPS, CTC_BETA_OPS = 15, 21
TRAIN_STEPS, TRAIN_WARMUP = 30, 5
TRAIN_BATCH = 32
# 3 train steps, kernel CTC vs plain CTC (the scan under autograd), from
# one state and seed: {compute dtype: (step-1 grad norm, losses, params)},
# relative; params as |p_kernel - p_plain| / |p_kernel - p_0| (global
# norms). Step 1 runs the same forward, so its loss agrees to CTC_TOL; its
# gradient is the analytic one vs autodiff, each ~1e-3 relative from exact
# at these losses (phase 7's fp64 check). From step 2 on the parameters
# differ, and a randomly initialized model spreads that over 3 Novograd
# steps; in bf16 it also flips the rounding of weights and activations.
TRAIN_ROUTE_TOLS = {None: (1e-3, 1e-3, 0.1),
                    "bfloat16": (1e-3, 2.0 ** -8, 0.5)}


def device_profile(fn, reps: int = 20):
    """fn() run reps times (after one warm-up) under the CUPTI trace:
    [(ms per call, launches per call, name)] of the kernels and copies it
    ran on the card, largest first. The host ops that launched them carry
    the same time again and are left out, as are CUPTI's own buffer
    requests. On the H100 machine a trace sometimes holds only part of a
    kernel's launches (kernel_ms divides by the count it saw)."""
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


def event_ms(fn, reps: int = 20) -> float:
    """ms per fn() call by CUDA events around `reps` calls after a warm-up:
    an upper bound on what fn() runs on the card. A sleep kernel (~25 ms)
    goes first, so that the host queues the calls while the card is busy
    and its launch gaps do not count (the repeat wrapper costs the host
    more than most of its launches cost the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name: str, reps: int = 20, launches: int = 1):
    """One kernel's device time per fn() call, fn() launching it `launches`
    times. The CUPTI trace gives the kernel alone, but on the H100 machine
    a trace sometimes holds only part of the launches, and then its
    durations are not to be trusted either. So: CUPTI's time where the
    trace saw every launch, else `event_ms`'s. Returns (ms, launches per
    call traced, event ms)."""
    rows = [r for r in device_profile(fn, reps) if name in r[2]]
    traced = sum(r[1] for r in rows)
    ev_ms = event_ms(fn, reps)
    if abs(traced - launches) > 1e-6:
        return ev_ms, traced, ev_ms
    return sum(r[0] for r in rows), traced, ev_ms


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def frontend_bounds(cfg, tables, mel, bsz, sp, t_out, n_tiles):
    """(bound_ms, bound_by, dft_bound_ms) of one kernel call. bound_ms: the
    larger of the function's bytes (xp, seq_len, the log-mel and the
    partials, the constants, each once) at PEAK_BYTES and a real FFT's
    operations, 2.5 n_fft log2(n_fft) a frame, plus the power (3 a bin),
    the mel's nonzero taps (2 each) and the log, guard and partials (4 a
    mel), at PEAK_FP32. dft_bound_ms: the same function counted with the
    DFT as frames @ matrix over the window's nonzero samples (2 * rows *
    2 * n_bins a frame) and the DFT matrix's bytes, the count the DFT
    kernel was held to."""
    import math

    n_fft, n_mels = cfg.fft_length, cfg.features
    nb = n_fft // 2 + 1
    frames = bsz * t_out
    mel_taps = int((mel != 0).sum())
    tail = 3 * nb + 2 * mel_taps + 4 * n_mels
    io = 4 * (bsz * sp + bsz + frames * n_mels + bsz * n_tiles * 2 * n_mels)
    const = sum(t.numel() * t.element_size() for t in (
        tables.window, tables.twiddle, tables.mel_index, tables.mel_weight))
    t_ops = frames * (2.5 * n_fft * math.log2(n_fft) + tail) / PEAK_FP32
    t_bytes = (io + const) / PEAK_BYTES
    rows = int((tables.window != 0).sum())
    d_ops = frames * (2 * rows * 2 * nb + tail) / PEAK_FP32
    d_bytes = (io + 4 * (n_fft * 2 * nb + nb * n_mels)) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(d_ops, d_bytes) * 1e3)


def frontend_fp64_logmel(torch, xp, cfg, mel):
    """The log-mel frames in fp64: an fp64 DFT of the same frames with the
    fp64 window, power, the mel matrix in fp64, log with the guard."""
    from vietasr_tpu_torch.frontend.features import _window_full

    win = torch.as_tensor(_window_full(cfg), device=xp.device)
    frames = xp.double().unfold(1, cfg.fft_length, cfg.hop_length) * win
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    m = power @ mel.double()
    if cfg.log_zero_guard_type == "clamp":
        return torch.log(torch.clamp_min(m, cfg.log_zero_guard_value))
    return torch.log(m + cfg.log_zero_guard_value)


def frontend_composition(torch, xp, cfg, window, mel):
    """The function as library calls, a yardstick the port never calls:
    torch.stft (cuFFT) of the padded signal with the fp32 window, |X|^2,
    the mel matmul, log with the guard."""
    spec = torch.stft(xp, cfg.fft_length, hop_length=cfg.hop_length,
                      win_length=cfg.fft_length, window=window,
                      center=False, return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    return torch.log(power @ mel + cfg.log_zero_guard_value)


def frontend_phase(np, torch, dev):
    from vietasr_tpu_torch.frontend.cuda_frontend import (
        FRAMES_PER_TILE, fft_tables, fused_log_mel_features,
        fused_log_mel_features_plain, log_mel_tiles_cuda,
        log_mel_tiles_plain)
    from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                     _mel_matrix,
                                                     _windowed_dft_matrix,
                                                     feature_seq_len,
                                                     preemphasize_and_pad)

    worst = {"feats": 0.0, "fp64": 0.0, "plain_fp64": 0.0, "parts": 0.0}
    by_shape, row = {}, None
    for n_mels in (64, 80):
        cfg = FeaturizerConfig(dither=0.0, features=n_mels)
        dft = torch.as_tensor(_windowed_dft_matrix(cfg), device=dev)
        mel = torch.as_tensor(_mel_matrix(cfg), device=dev)
        tables = fft_tables(cfg, dev)     # once per config, as in use
        for bsz, seconds in ((1, 2.0), (8, 2.0), (1, 8.0), (8, 8.0),
                             (1, 16.7), (8, 16.7), (32, 16.7)):
            what = f"frontend {n_mels} mels B={bsz} {seconds} s"
            rng = np.random.RandomState(int(seconds * 10) + bsz + n_mels)
            n = int(seconds * cfg.sample_rate)
            sig = torch.from_numpy(
                (rng.randn(bsz, n) * 0.1).astype(np.float32)).to(dev)
            lens = rng.randint(n // 4, n + 1, size=bsz).astype(np.int32)
            lens[0] = n
            lens = torch.from_numpy(lens).to(dev)
            got, got_len = fused_log_mel_features(sig, lens, cfg=cfg,
                                                  tables=tables)
            want, want_len = fused_log_mel_features_plain(
                sig, lens, cfg=cfg, dft_matrix=dft, mel_matrix=mel)
            # the kernel itself vs its plain version and an fp64 chain
            xp = preemphasize_and_pad(sig, cfg).contiguous()
            seq_len = feature_seq_len(lens, cfg.hop_length)
            lm_k, parts_k = log_mel_tiles_cuda(xp, seq_len, tables, cfg=cfg)
            lm_p, parts_p = log_mel_tiles_plain(xp, seq_len, dft, mel,
                                                cfg=cfg)
            lm_64 = frontend_fp64_logmel(torch, xp, cfg, mel)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all())
                  and bool(torch.isfinite(lm_k).all()), f"{what}: non-finite")
            check(got.shape == want.shape and bool((got_len == want_len)
                                                   .all()),
                  f"{what}: shape or seq_len differs from the plain version")
            err = float((got - want).abs().max())
            check(err < FRONTEND_TOL,
                  f"{what}: features max|d| {err} >= {FRONTEND_TOL}")
            lm_err = float((lm_k - lm_p).abs().max())
            k64 = float((lm_k.double() - lm_64).abs().max())
            p64 = float((lm_p.double() - lm_64).abs().max())
            check(k64 <= p64, f"{what}: log-mel {k64} from fp64, further "
                  f"than the plain chain's {p64}")
            p_err = float((parts_k - parts_p).abs().max()
                          / parts_p.abs().max())
            check(p_err <= FRONTEND_PARTS_RTOL,
                  f"{what}: partials {p_err} of their largest")
            for key, v in (("feats", err), ("fp64", k64),
                           ("plain_fp64", p64), ("parts", p_err)):
                worst[key] = max(worst[key], v)

            t_out = lm_k.shape[1]
            n_tiles = -(-t_out // FRAMES_PER_TILE)
            ms, seen, ev_ms = kernel_ms(lambda: log_mel_tiles_cuda(
                xp, seq_len, tables, cfg=cfg), "logmel_kernel")
            bound, bound_by, dft_bound = frontend_bounds(
                cfg, tables, mel, bsz, xp.shape[1], t_out, n_tiles)
            by_shape[f"{n_mels}x{bsz}x{seconds}s"] = ms
            print(f"{what}: feats {tuple(got.shape)} max|d| vs plain "
                  f"{err:.3e}, log-mel {lm_err:.3e}, partials {p_err:.3e} "
                  f"of their largest; log-mel vs fp64: kernel {k64:.3e}, "
                  f"plain {p64:.3e}; kernel {ms:.4f} ms ({seen:g} launches "
                  f"per call traced; events {ev_ms:.4f}), bound "
                  f"{bound:.4f} ms by {bound_by}, dft_bound {dft_bound:.4f}"
                  f" ms")
            if (n_mels, bsz, seconds) != (64, 8, 16.7) \
                    and (n_mels, bsz) != (64, 32):
                continue
            plain_ms = device_ms(lambda: log_mel_tiles_plain(
                xp, seq_len, dft, mel, cfg=cfg))
            comp = frontend_composition(torch, xp, cfg, tables.window, mel)
            comp_ms = device_ms(lambda: frontend_composition(
                torch, xp, cfg, tables.window, mel))
            c64 = float((comp.double() - lm_64).abs().max())
            print(f"  B={bsz} x {seconds} s ({bsz * t_out} frames): plain "
                  f"{plain_ms:.4f} ms, composition_ms {comp_ms:.4f} "
                  f"(torch.stft + |X|^2 + mel + log; log-mel vs fp64 "
                  f"{c64:.3e})")
            if bsz == 8:
                row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "dft_bound_ms": dft_bound,
                       "composition_ms": comp_ms}
    print(f"frontend: worst features max|d| {worst['feats']:.3e} (tol "
          f"{FRONTEND_TOL}), log-mel vs fp64 kernel {worst['fp64']:.3e} / "
          f"plain {worst['plain_fp64']:.3e}, partials {worst['parts']:.3e}")
    return {"name": "log_mel_frontend", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/frontend.cu",
            "replaces": "vietasr_tpu/frontend/pallas_frontend.py:51",
            "max_abs_err": worst["feats"], **row, "library_ms": None,
            "ms_by_shape": by_shape, "fp64_err": worst["fp64"],
            "plain_fp64_err": worst["plain_fp64"],
            "parts_rel_err": worst["parts"]}


def frontend_fast_bound(cfg, tables, mel, bsz, sp, t_out, n_tiles):
    """(bound_ms, bound_by) of one bf16 kernel call: the larger of the
    function's bytes (xp, seq_len, the log-mel and the partials, the bf16
    DFT rows and mel matrix, each once) at PEAK_BYTES and its bf16
    operations at PEAK_BF16, counted as frontend_bounds' dft_bound_ms
    counts them: frames @ DFT over the window's nonzero rows (2 * rows * 2
    * n_bins a frame), the power (3 a bin), the mel's nonzero taps (2
    each) and the log, guard and partials (4 a mel)."""
    from vietasr_tpu_torch.frontend.features import _window_full

    n_fft, n_mels = cfg.fft_length, cfg.features
    nb = n_fft // 2 + 1
    frames = bsz * t_out
    rows = int((_window_full(cfg).astype("float32") != 0).sum())
    ops = frames * (2 * rows * 2 * nb + 3 * nb + 2 * int((mel != 0).sum())
                    + 4 * n_mels)
    io = 4 * (bsz * sp + bsz + frames * n_mels + bsz * n_tiles * 2 * n_mels)
    const = 2 * (tables.dft.numel() + tables.mel.numel())
    t_ops, t_bytes = ops / PEAK_BF16, (io + const) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def frontend_fast_composition(torch, xp, cfg, dft16, mel16):
    """The bf16 function as library calls, a yardstick the port never
    calls: bf16 torch.matmul of the frames and the DFT matrix (bf16 out),
    |X|^2, bf16 mel matmul, log with the guard."""
    nb = cfg.fft_length // 2 + 1
    frames = xp.to(torch.bfloat16).unfold(1, cfg.fft_length, cfg.hop_length)
    spec = torch.matmul(frames, dft16)
    power = spec[..., :nb] ** 2 + spec[..., nb:] ** 2
    return torch.log(torch.matmul(power, mel16).float()
                     + cfg.log_zero_guard_value)


def mel_power(torch, logmel, cfg):
    """The mel power a log-mel came from, in fp64 (the inverse of the add
    guard; the clamp guard's floor stays at the guard)."""
    m = torch.exp(logmel.double())
    return m - cfg.log_zero_guard_value \
        if cfg.log_zero_guard_type == "add" else m


# phase 3b's shapes beyond phase 3's 14: (mels, hop, B, seconds, lengths or
# None for ragged ones with row 0 full). The largest hop the bf16 kernel's
# plan takes with 64 mels (64-frame blocks), and B = 3 with rows whose
# frames end inside a 128-frame block and inside a 16-frame partials tile
# (434 = 3 * 128 + 50 and 230 = 128 + 102 frames)
FAST_EXTRA_SHAPES = ((64, None, 2, 8.0, None),
                     (64, 160, 3, 16.7, (267200, 69317, 36800)))


def fast_widest_hop(n_mels: int) -> int:
    """The largest hop (a multiple of 8 up to n_fft 512) that the bf16
    kernel's launch plan takes with n_mels mels and the 20 ms window."""
    from vietasr_tpu_torch.frontend.cuda_frontend import fast_shape_plan

    return max(h for h in range(8, 513, 8)
               if fast_shape_plan(512, h, n_mels, 320) is not None)


def frontend_fast_phase(np, torch, dev):
    """Phase 3b: the bf16 frontend kernel vs its plain version at phase 3's
    shapes and signals, then at FAST_EXTRA_SHAPES; each shape's launch plan
    (frames a block, ring stages, DFT columns a stage, shared memory,
    blocks launched)."""
    from vietasr_tpu_torch.frontend.cuda_frontend import (
        FRAMES_PER_TILE, fast_plan, fast_tables, fft_tables,
        fused_log_mel_features, fused_log_mel_features_plain,
        log_mel_tiles_cuda, log_mel_tiles_fast_cuda,
        log_mel_tiles_fast_plain, tile_partials)
    from vietasr_tpu_torch.frontend.features import (FeaturizerConfig,
                                                     _mel_matrix,
                                                     _windowed_dft_matrix,
                                                     feature_seq_len,
                                                     preemphasize_and_pad)

    shapes = [(n_mels, 160, bsz, seconds, None) for n_mels in (64, 80)
              for bsz, seconds in ((1, 2.0), (8, 2.0), (1, 8.0), (8, 8.0),
                                   (1, 16.7), (8, 16.7), (32, 16.7))]
    shapes += [(m, hop or fast_widest_hop(m), bsz, seconds, lens)
               for m, hop, bsz, seconds, lens in FAST_EXTRA_SHAPES]
    worst = {"mel": 0.0, "logmel": 0.0, "parts": 0.0}
    by_shape, row, consts = {}, {}, {}
    for n_mels, hop, bsz, seconds, fixed in shapes:
        cfg = FeaturizerConfig(dither=0.0, features=n_mels,
                               window_stride=hop / 16000)
        if (n_mels, hop) not in consts:    # once per config, as in use
            consts[(n_mels, hop)] = (
                torch.as_tensor(_windowed_dft_matrix(cfg), device=dev),
                torch.as_tensor(_mel_matrix(cfg), device=dev),
                fast_tables(cfg, dev), fft_tables(cfg, dev))
        dft, mel, tables, fp64_tables = consts[(n_mels, hop)]
        what = f"bf16 frontend {n_mels} mels hop {hop} B={bsz} {seconds} s"
        rng = np.random.RandomState(int(seconds * 10) + bsz + n_mels)
        n = int(seconds * cfg.sample_rate)
        sig = torch.from_numpy(
            (rng.randn(bsz, n) * 0.1).astype(np.float32)).to(dev)
        if fixed is None:
            lens = rng.randint(n // 4, n + 1, size=bsz).astype(np.int32)
            lens[0] = n
        else:
            lens = np.asarray(fixed, np.int32)
        lens = torch.from_numpy(lens).to(dev)
        got, got_len = fused_log_mel_features(
            sig, lens, cfg=cfg, tables=tables, precision="default")
        want, want_len = fused_log_mel_features_plain(
            sig, lens, cfg=cfg, dft_matrix=dft, mel_matrix=mel,
            precision="default")
        xp = preemphasize_and_pad(sig, cfg).contiguous()
        seq_len = feature_seq_len(lens, cfg.hop_length)
        lm_k, parts_k = log_mel_tiles_fast_cuda(xp, seq_len, tables,
                                                cfg=cfg)
        plan = fast_plan(cfg)
        blocks = log_mel_tiles_fast_cuda.last_blocks
        lm_p, _ = log_mel_tiles_fast_plain(xp, seq_len, dft, mel,
                                           cfg=cfg)
        lm_h, _ = log_mel_tiles_cuda(xp, seq_len, fp64_tables, cfg=cfg)
        lm_64 = frontend_fp64_logmel(torch, xp, cfg, mel)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all())
              and bool(torch.isfinite(lm_k).all()), f"{what}: non-finite")
        check(got.shape == want.shape
              and bool((got_len == want_len).all()),
              f"{what}: shape or seq_len differs from the plain version")
        m_p = mel_power(torch, lm_p, cfg)
        mel_err = float(((mel_power(torch, lm_k, cfg) - m_p).abs()
                         / m_p.amax(-1, keepdim=True)).max())
        check(mel_err <= FAST_MEL_TOL, f"{what}: mel power {mel_err} of "
              f"the frame's largest > {FAST_MEL_TOL}")
        own = tile_partials(lm_k, seq_len)
        p_err = float((parts_k - own).abs().max() / own.abs().max())
        check(p_err <= FRONTEND_PARTS_RTOL, f"{what}: partials {p_err} "
              "of the largest of its own log-mel's")
        lm_err = float((lm_k - lm_p).abs().max())
        for key, v in (("mel", mel_err), ("logmel", lm_err),
                       ("parts", p_err)):
            worst[key] = max(worst[key], v)
        d64 = {}
        for name, lm in (("kernel", lm_k), ("plain", lm_p),
                         ("fp32 kernel", lm_h)):
            d = (lm.double() - lm_64).abs().flatten()
            q = torch.quantile(d.float(),
                               torch.tensor([0.5, 0.99], device=dev))
            d64[name] = (float(q[0]), float(q[1]), float(d.max()))

        t_out = lm_k.shape[1]
        n_tiles = -(-t_out // FRAMES_PER_TILE)
        ms, seen, ev_ms = kernel_ms(lambda: log_mel_tiles_fast_cuda(
            xp, seq_len, tables, cfg=cfg), "logmel_fast_kernel")
        bound, bound_by = frontend_fast_bound(
            cfg, tables, mel, bsz, xp.shape[1], t_out, n_tiles)
        by_shape[f"{n_mels}x{bsz}x{seconds}s" if hop == 160 else
                 f"{n_mels}x{bsz}x{seconds}s_hop{hop}"] = ms
        print(f"{what}: plan {plan.frames} frames a block, {plan.stages} "
              f"stages of {plan.chunk_cols} DFT columns, {plan.smem} bytes "
              f"of shared memory, {blocks} blocks; mel power vs plain "
              f"{mel_err:.3e} of the frame's largest, log-mel {lm_err:.3e}, "
              f"partials {p_err:.3e}; |d log-mel| from fp64 p50/p99/max: "
              + ", ".join(f"{k} {a:.3e}/{b:.3e}/{c:.3e}"
                          for k, (a, b, c) in d64.items())
              + f"; kernel {ms:.4f} ms ({seen:g} launches per call "
              f"traced; events {ev_ms:.4f}), bound {bound:.4f} ms by "
              f"{bound_by}")
        if n_mels != 64 or hop != 160 or fixed is not None \
                or (bsz, seconds) not in ((8, 16.7), (32, 16.7)):
            continue
        plain_ms = device_ms(lambda: log_mel_tiles_fast_plain(
            xp, seq_len, dft, mel, cfg=cfg))
        dft16, mel16 = dft.to(torch.bfloat16), mel.to(torch.bfloat16)
        comp_ms = device_ms(lambda: frontend_fast_composition(
            torch, xp, cfg, dft16, mel16))
        print(f"  B={bsz} x {seconds} s ({bsz * t_out} frames): plain "
              f"{plain_ms:.4f} ms, composition_ms {comp_ms:.4f} (bf16 "
              "torch.matmul frames @ DFT + |X|^2 + bf16 mel matmul + "
              "log)")
        if bsz == 8:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by=bound_by, composition_ms=comp_ms,
                       plan={"frames_per_block": plan.frames,
                             "stages": plan.stages,
                             "chunk_cols": plan.chunk_cols,
                             "smem_bytes": plan.smem, "blocks": blocks})
        else:
            row.update(ms_b32=ms, plain_ms_b32=plain_ms,
                       bound_ms_b32=bound, composition_ms_b32=comp_ms)
    print(f"bf16 frontend: worst mel power {worst['mel']:.3e} of the "
          f"frame's largest (tol {FAST_MEL_TOL}), log-mel "
          f"{worst['logmel']:.3e}, partials {worst['parts']:.3e} over "
          f"{len(shapes)} shapes")
    return {"name": "frontend_fast", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/frontend_fast.cu",
            "replaces": "vietasr_tpu/frontend/pallas_frontend.py:51",
            "precision": "default", "launches": 0,
            "max_abs_err": worst["logmel"], **row,
            "library_ms": None, "ms_by_shape": by_shape,
            "mel_power_rel_err": worst["mel"],
            "parts_rel_err": worst["parts"]}


def repeat_bound_ms(bsz, t, c_in, c_out, k, r, has_res, rows):
    """Least time for one fused block: the larger of its bf16 GEMM work on
    the tensor cores and its fp32 depthwise work on the CUDA cores (the two
    units run side by side), or its bytes. Only the `rows` time rows that
    lie inside their lengths (sum of min(len, T)) need a product or their
    input: a row past its length comes out as its bias alone. So the
    operations and the bf16 input bytes count those rows, the output bytes
    every row, the weights once. The R > 1 intermediates are not counted:
    the block needs none of them in memory."""
    cs = [c_in] + [c_out] * (r - 1)
    gemm = sum(2 * rows * c * c_out for c in cs)
    gemm += 2 * rows * c_in * c_out if has_res else 0
    dw = sum(2 * rows * c * k for c in cs)
    t_ops = max(gemm / PEAK_BF16, dw / PEAK_FP32) * 1e3
    nbytes = (2 * rows * c_in + 2 * bsz * t * c_out + 4 * bsz
              + sum(4 * k * c + 2 * c * c_out + 4 * c_out for c in cs)
              + ((2 * c_in * c_out + 4 * c_out) if has_res else 0))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# (C_in, C_out, K, R, B, T, count per forward): the 13 eligible blocks of
# QuartzNet12x1 at the 16.7 s bucket with B = 8 (the 64-row grids); the
# 512-wide blocks at the grids of phase 5's three small forwards (B = 2 x
# 6 s, B = 4 x 8 s, B = 2 x 11 s: 32-row blocks whose output columns split
# over two blocks per tile) and two 256-wide ones (32-row blocks, one
# column group); then two multi-repeat shapes (the whole-block kernel)
REPEAT_SHAPES = [(256, 256, 33, 1, 8, 840, 3), (256, 256, 39, 1, 8, 840, 3),
                 (256, 512, 51, 1, 8, 840, 1), (512, 512, 51, 1, 8, 840, 2),
                 (512, 512, 63, 1, 8, 840, 3), (512, 512, 75, 1, 8, 840, 1),
                 *((c_in, 512, k, 1, bsz, t, 0)
                   for bsz, t in ((2, 304), (4, 408), (2, 552))
                   for c_in, k in ((256, 51), (512, 63), (512, 75))),
                 (256, 256, 33, 1, 2, 304, 0), (256, 256, 39, 1, 4, 408, 0),
                 (64, 64, 9, 3, 8, 100, 0), (32, 48, 7, 2, 8, 70, 0)]


def repeat_inputs(np, torch, dev, c_in, c_out, k, r, t, bsz=8, full=False):
    """Phase 4's seeded operands of one block shape: x (B, T, C_in) bf16,
    lengths drawn from U[T/4, T] with row 0 full (every row full with
    `full`), fp32 taps and biases, bf16 1x1 weights, a residual."""
    rng = np.random.RandomState(c_in + c_out + k + r)

    def arr(*shape, scale=1.0, dtype=torch.float32):
        a = (rng.randn(*shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    x = arr(bsz, t, c_in, scale=0.5, dtype=torch.bfloat16)
    lens = rng.randint(t // 4, t + 1, size=bsz).astype(np.int32)
    lens[0] = t
    if full:
        lens[:] = t
    lens = torch.from_numpy(lens).to(dev)
    cs = [c_in] + [c_out] * (r - 1)
    dws = [arr(k, c, scale=k ** -0.5) for c in cs]
    pws = [arr(c, c_out, scale=c ** -0.5, dtype=torch.bfloat16) for c in cs]
    bs = [arr(c_out, scale=0.1) for _ in cs]
    res_w = arr(c_in, c_out, scale=c_in ** -0.5, dtype=torch.bfloat16)
    res_b = arr(c_out, scale=0.1)
    return x, lens, dws, pws, bs, res_w, res_b


def repeat_launches(bsz, t, c_in, c_out, k, r, lens):
    """R = 1: [(time rows per block, column groups, blocks, blocks skipped
    as padding)] of the one-repeat kernel's launch, as it plans it on this
    card. R >= 2: the whole-block kernel's one launch, [(tile rows, cluster
    size, blocks, blocks skipped as padding, shared-memory bytes a block,
    clusters the card holds at once)]."""
    from vietasr_tpu_torch.ops.repeat_block import (
        launch_plan, whole_block_clusters_at_once, whole_block_kernel_smem,
        whole_block_plan)

    valid = lens.clamp(0, t).tolist()
    if r > 1:
        plan = whole_block_plan(
            bsz, t, c_in, c_out, k, r,
            clusters_at_once=whole_block_clusters_at_once)
        check(whole_block_kernel_smem(plan, k, r) == plan.smem_bytes,
              f"whole-block plan {plan}: the kernel counts other shared "
              "memory")
        tt, n = plan.tile_rows, plan.cluster
        return [(tt, n, plan.tiles * bsz * n,
                 n * sum(plan.tiles - -(-v // tt) for v in valid),
                 plan.smem_bytes,
                 whole_block_clusters_at_once(n, plan.smem_bytes))]
    tt, groups = launch_plan(True, bsz, t, c_in, c_out, c_in, True, k)
    tiles = -(-t // tt)
    return [(tt, groups, tiles * bsz * groups,
             groups * sum(tiles - -(-n // tt) for n in valid))]


def repeat_composition(torch, x, mask, dw_conv, pw, b, res_w, res_b, k):
    """The R = 1 block as library calls, a yardstick the port never calls:
    the masked depthwise by F.conv1d in fp32 (cuDNN, TF32 off), two bf16
    torch.matmul (cuBLAS, fp32 sums, bf16 out), biases and ReLU."""
    import torch.nn.functional as F

    xm = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
    y = F.conv1d(xm.float().transpose(1, 2), dw_conv, padding=k // 2,
                 groups=dw_conv.shape[0]).transpose(1, 2)
    y = torch.where(mask, y, 0.0).to(torch.bfloat16)
    z = torch.matmul(y, pw) + b + (torch.matmul(xm, res_w) + res_b)
    return torch.relu(z).to(torch.bfloat16)


def repeat_phase(np, torch, dev):
    from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                    fused_repeat_block_plain)

    worst = 0.0
    tot = {"ms": 0.0, "full_length_ms": 0.0, "plain_ms": 0.0,
           "composition_ms": 0.0, "bound_ms": 0.0, "bound_full_ms": 0.0}
    bound_by_main = set()
    plans = set()
    for c_in, c_out, k, r, bsz, t, per_fwd in REPEAT_SHAPES:
        times = {}
        for full in (False, True):
            args = repeat_inputs(np, torch, dev, c_in, c_out, k, r, t, bsz,
                                 full)
            got = fused_repeat_block(*args, kernel=k)
            want = fused_repeat_block_plain(*args, kernel=k)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            what = f"repeat ({c_in},{c_out},{k},R={r}) B={bsz} T={t} " \
                f"full={full}"
            check(got.shape == want.shape and got.dtype == torch.bfloat16,
                  f"{what}: shape or dtype differs from the plain version")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{what}: non-finite")
            check(err <= REPEAT_TOL_REL * scale,
                  f"{what}: max|d| {err} > {REPEAT_TOL_REL} * {scale}")
            worst = max(worst, err)
            plan = repeat_launches(bsz, t, c_in, c_out, k, r, args[1])
            if r == 1:
                plans.update(p[:2] for p in plan)
            ms, seen, ev_ms = kernel_ms(
                lambda: fused_repeat_block(*args, kernel=k),
                "repeat_kernel" if r == 1 else "whole_block_kernel")
            rows = int(args[1].clamp(0, t).sum())
            bound, bound_by = repeat_bound_ms(bsz, t, c_in, c_out, k, r,
                                              True, rows)
            times[full] = (ms, bound)
            line = (f"repeat (C_in {c_in}, C_out {c_out}, K {k}, R {r}) "
                    f"B={bsz} T={t} {'full' if full else 'ragged'} lengths "
                    f"({rows} valid rows): max|d| {err:.3e} (max|want| "
                    f"{scale:.3f}), {ms:.4f} ms ({seen:g} traced per call; "
                    f"events {ev_ms:.4f}), bound {bound:.4f} ms by "
                    f"{bound_by}; launches {plan}")
            if not full:
                plain_ms = device_ms(lambda: fused_repeat_block_plain(
                    *args, kernel=k))
                line += f", plain {plain_ms:.4f} ms"
                tot["plain_ms"] += per_fwd * plain_ms
                if per_fwd:
                    bound_by_main.add(bound_by)
            if not full and per_fwd:
                x, lens, dws, pws, bs, res_w, res_b = args
                mask = (torch.arange(t, device=dev)[None, :]
                        < lens[:, None])[:, :, None]
                dw_conv = dws[0].t().unsqueeze(1).contiguous()
                comp = repeat_composition(torch, x, mask, dw_conv, pws[0],
                                          bs[0], res_w, res_b, k)
                comp_err = float((comp.float() - want.float()).abs().max())
                comp_ms = device_ms(lambda: repeat_composition(
                    torch, x, mask, dw_conv, pws[0], bs[0], res_w, res_b, k))
                line += (f", composition {comp_ms:.4f} ms (max|d| vs plain "
                         f"{comp_err:.3e})")
                tot["composition_ms"] += per_fwd * comp_ms
            print(line + f", x{per_fwd} per forward")
        tot["ms"] += per_fwd * times[False][0]
        tot["bound_ms"] += per_fwd * times[False][1]
        tot["full_length_ms"] += per_fwd * times[True][0]
        tot["bound_full_ms"] += per_fwd * times[True][1]
    check({(64, 1), (32, 1), (32, 2)} <= plans,
          f"repeat: phase 4 held only the launch plans {sorted(plans)} "
          "against the plain version")
    print("repeat launches: R = 1 (rows per block, column groups, blocks, "
          "skipped as padding); R > 1 the whole-block kernel (tile rows, "
          "cluster, blocks, skipped as padding, smem bytes a block, clusters "
          "the card holds at once)")
    print(f"composition_ms (F.conv1d fp32 + 2 bf16 matmuls + bias + ReLU, "
          f"13 blocks of one forward, ragged lengths): "
          f"{tot['composition_ms']:.4f}")
    print(f"repeat kernel, 13 launches of one forward at B=8 x 16.7 s: "
          f"ragged lengths {tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f}),"
          f" full lengths {tot['full_length_ms']:.4f} ms (bound "
          f"{tot['bound_full_ms']:.4f}), plain {tot['plain_ms']:.4f} ms")
    return {"name": "repeat_block", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/repeat_block.cu",
            "replaces": "vietasr_tpu/ops/pallas_repeat.py:57",
            "max_abs_err": worst, **tot,
            "bound_by": "/".join(sorted(bound_by_main)), "library_ms": None}


# (C_in, C_out, K, blocks per forward): QuartzNet15x5's R = 5 blocks at the
# 16.7 s bucket with B = 8 (T = 840 encoder frames)
QN15X5_REPEAT_SHAPES = ((256, 256, 33, 3), (256, 256, 39, 3),
                        (256, 512, 51, 1), (512, 512, 51, 2),
                        (512, 512, 63, 3), (512, 512, 75, 3))


def repeat_whole_phase(np, torch, dev):
    """Phase 4 at R = 5: the whole-block kernel at QuartzNet15x5's six
    block shapes (B = 8, T = 840), at ragged and at full lengths, held to
    the plain version; its time beside the bound and beside the R-launch
    chain of the one-repeat kernel (a yardstick, held too)."""
    from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                    fused_repeat_block_plain,
                                                    repeat_chain_cuda,
                                                    repeat_whole_block_cuda)

    bsz, t, r = 8, 840, 5
    worst = 0.0
    tot = dict.fromkeys(("ms", "full_length_ms", "plain_ms", "chain_ms",
                         "chain_full_length_ms", "bound_ms",
                         "bound_full_ms"), 0.0)
    by_shape, bound_by = {}, set()
    for c_in, c_out, k, per_fwd in QN15X5_REPEAT_SHAPES:
        for full in (False, True):
            args = repeat_inputs(np, torch, dev, c_in, c_out, k, r, t, bsz,
                                 full)
            what = f"whole block ({c_in},{c_out},{k},R={r}) B={bsz} T={t} " \
                f"full={full}"
            launches = repeat_whole_block_cuda.launches
            got = fused_repeat_block(*args, kernel=k)
            torch.cuda.synchronize()
            check(repeat_whole_block_cuda.launches == launches + 1,
                  f"{what}: not one whole-block launch")
            want = fused_repeat_block_plain(*args, kernel=k)
            chain = repeat_chain_cuda(*args, kernel=k)
            torch.cuda.synchronize()
            scale = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            chain_err = float((chain.float() - want.float()).abs().max())
            check(got.shape == want.shape and got.dtype == torch.bfloat16,
                  f"{what}: shape or dtype differs from the plain version")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{what}: non-finite")
            check(err <= REPEAT_TOL_REL * scale,
                  f"{what}: max|d| {err} > {REPEAT_TOL_REL} * {scale}")
            check(chain_err <= REPEAT_TOL_REL * scale,
                  f"{what}: the chain's max|d| {chain_err} > "
                  f"{REPEAT_TOL_REL} * {scale}")
            worst = max(worst, err)
            plan = repeat_launches(bsz, t, c_in, c_out, k, r, args[1])
            ms, seen, ev_ms = kernel_ms(
                lambda: fused_repeat_block(*args, kernel=k),
                "whole_block_kernel")
            chain_ms, cseen, cev_ms = kernel_ms(
                lambda: repeat_chain_cuda(*args, kernel=k), "repeat_kernel",
                launches=r)
            rows = int(args[1].clamp(0, t).sum())
            bound, by = repeat_bound_ms(bsz, t, c_in, c_out, k, r, True,
                                        rows)
            entry = {"ms": ms, "chain_ms": chain_ms, "bound_ms": bound,
                     "plan": plan[0]}
            line = (f"whole block (C_in {c_in}, C_out {c_out}, K {k}, R {r})"
                    f" B={bsz} T={t} {'full' if full else 'ragged'} lengths "
                    f"({rows} valid rows): max|d| {err:.3e} (chain "
                    f"{chain_err:.3e}, max|want| {scale:.3f}), {ms:.4f} ms "
                    f"({seen:g} traced per call; events {ev_ms:.4f}), chain "
                    f"of {r} launches {chain_ms:.4f} ms ({cseen:g} traced; "
                    f"events {cev_ms:.4f}), whole / chain "
                    f"{ms / chain_ms:.3f}, bound {bound:.4f} ms by {by}; "
                    f"launch {plan[0]}")
            if full:
                tot["full_length_ms"] += per_fwd * ms
                tot["chain_full_length_ms"] += per_fwd * chain_ms
                tot["bound_full_ms"] += per_fwd * bound
            else:
                plain_ms = device_ms(lambda: fused_repeat_block_plain(
                    *args, kernel=k))
                entry["plain_ms"] = plain_ms
                line += f", plain {plain_ms:.4f} ms"
                tot["ms"] += per_fwd * ms
                tot["chain_ms"] += per_fwd * chain_ms
                tot["plain_ms"] += per_fwd * plain_ms
                tot["bound_ms"] += per_fwd * bound
                bound_by.add(by)
            by_shape[f"{c_in}-{c_out}-{k}{'-full' if full else ''}"] = entry
            print(line + f", x{per_fwd} per 15x5 forward")
    print(f"whole-block kernel, 15 launches of one QuartzNet15x5 forward at "
          f"B=8 x 16.7 s: ragged lengths {tot['ms']:.4f} ms (bound "
          f"{tot['bound_ms']:.4f}, chain of 75 launches "
          f"{tot['chain_ms']:.4f}, whole / chain "
          f"{tot['ms'] / tot['chain_ms']:.3f}), full lengths "
          f"{tot['full_length_ms']:.4f} ms (chain "
          f"{tot['chain_full_length_ms']:.4f}), plain {tot['plain_ms']:.4f} "
          "ms")
    return {"name": "repeat_whole_block", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/repeat_whole_block.cu",
            "replaces": "vietasr_tpu/ops/pallas_repeat.py:57",
            "launches": 0, "max_abs_err": worst, **tot,
            "bound_by": "/".join(sorted(bound_by)), "library_ms": None,
            "ms_by_shape": by_shape}


def mixed_signals(np, sr=16000):
    """16 seeded signals (x 0.1): 8 of 11.5-16.5 s fill one B = 8 batch of
    the 16.7 s bucket; 8 of 1.5-10.5 s spread over the shorter buckets."""
    rng = np.random.RandomState(1234)
    secs = list(rng.uniform(11.5, 16.5, size=8)) \
        + list(rng.uniform(1.5, 10.5, size=8))
    return [(rng.randn(int(s * sr)) * 0.1).astype(np.float32) for s in secs]


def end_to_end_phase(np, torch, dev, kernels):
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.models.convert import load_anchor
    from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                    repeat_whole_block_cuda)
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    sr = 16000
    signals = mixed_signals(np)
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
    repeat_whole_block_cuda.launches = 0
    texts = tr.transcribe_batch(signals)               # the main path
    launches = {"log_mel_frontend": fused_log_mel_features.launches,
                "repeat_block": fused_repeat_block.launches,
                "repeat_whole_block": repeat_whole_block_cuda.launches}
    print(f"main path: {len(signals)} signals, {forwards} forwards, "
          f"launches {launches}")
    check(launches["log_mel_frontend"] == forwards,
          f"frontend kernel launched {launches['log_mel_frontend']} times "
          f"for {forwards} forwards")
    check(launches["repeat_block"] == 13 * forwards,
          f"repeat kernel launched {launches['repeat_block']} times, want "
          f"13 x {forwards}")
    check(launches["repeat_whole_block"] == 0,
          "the whole-block kernel launched on QuartzNet12x1 (R = 1)")
    for k in kernels:
        if k["name"] != "repeat_whole_block":     # its main path: phase 15
            k["launches"] = launches[k["name"]]
    add_path_launches(kernels, "greedy", launches)

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


def agreement(a, b):
    """Frame argmax agreement of two (B, T, V) log-prob arrays."""
    return float((a.argmax(-1) == b.argmax(-1)).mean())


def path_numbers(np, torch, tr, signals, what):
    """audio-s/s of transcribe_batch(signals) (host clock, 5 calls after
    the caller's warm-up) and the CUPTI device busy / idle share of one
    call; printed, returned as (audio-s/s, busy ms, idle share)."""
    audio_s = sum(len(s) for s in signals) / 16000
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.transcribe_batch(signals)
    dt = (time.perf_counter() - t0) / reps
    rows = device_profile(lambda: tr.transcribe_batch(signals), reps=5)
    busy_ms = sum(r[0] for r in rows)
    idle = 1 - busy_ms / (dt * 1e3)
    print(f"{what}: {audio_s:.1f} audio-s in {dt * 1e3:.2f} ms = "
          f"{audio_s / dt:.1f} audio-s/s; device busy {busy_ms:.4f} ms "
          f"({100 * idle:.1f} % idle)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.4f} ms  x{count:<4g} {key[:100]}")
    return audio_s / dt, busy_ms, idle


def fast_int8_phase(np, torch, dev, signals):
    """Phase 5c: Transcriber(fused_frontend="fast") and calibrate_int8
    over phase 5's signals, the launch counters read around each path.
    Returns the bf16 frontend kernel's launches on its path."""
    from vietasr_tpu_torch.frontend.cuda_frontend import (
        fused_log_mel_features, log_mel_tiles_fast_cuda)
    from vietasr_tpu_torch.models.quantize import (int8_matmul,
                                                   int8_matmul_plain,
                                                   int8_pw_fn)
    from vietasr_tpu_torch.models.quartznet import quartznet_apply
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    base = Transcriber(CONFIG, checkpoint=ANCHOR)
    fast = Transcriber(CONFIG, checkpoint=ANCHOR,
                       options=TranscriberOptions(fused_frontend="fast"))
    base_texts = base.transcribe_batch(signals)
    fast.transcribe_batch(signals)                     # warm-up
    groups = {}
    for s in signals:
        groups.setdefault(fast._bucket_len(len(s)), []).append(s)
    forwards = sum(-(-len(g) // fast.opts.max_batch) for g in groups.values())

    def counted(tr):
        fused_log_mel_features.launches = 0
        log_mel_tiles_fast_cuda.launches = 0
        fused_repeat_block.launches = 0
        texts = tr.transcribe_batch(signals)
        return texts, {"frontend_fp64": fused_log_mel_features.launches,
                       "frontend_fast": log_mel_tiles_fast_cuda.launches,
                       "repeat_block": fused_repeat_block.launches}

    texts, launches = counted(fast)                    # the "fast" path
    print(f"fast path: {len(signals)} signals, {forwards} forwards, "
          f"launches {launches}")
    check(launches == {"frontend_fp64": 0, "frontend_fast": forwards,
                       "repeat_block": 13 * forwards},
          f"fast path launches {launches} for {forwards} forwards")
    fast_launches = launches["frontend_fast"]
    base_lp = [base.log_probs(s)[0] for s in signals]
    agree = [agreement(fast.log_probs(s)[0], lp)
             for s, lp in zip(signals, base_lp)]
    same = sum(a == b for a, b in zip(texts, base_texts))
    print(f"fast path vs the default route: frame argmax agreement mean "
          f"{np.mean(agree):.4f}, min {min(agree):.4f} (min "
          f"{FAST_ARGMAX_MIN}); transcripts equal {same}/{len(texts)}")
    check(min(agree) >= FAST_ARGMAX_MIN, "fast path: argmax agreement "
          f"{min(agree)} < {FAST_ARGMAX_MIN}")
    path_numbers(np, torch, fast, signals, "fast path end to end")
    del fast

    q = Transcriber(CONFIG, checkpoint=ANCHOR)
    t0 = time.perf_counter()
    q.calibrate_int8(signals)
    torch.cuda.synchronize()
    print(f"calibrate_int8 over {len(signals)} signals: "
          f"{len(q._q_tables)} int8 sites in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    check(len(q._q_tables) == 28, f"int8: {len(q._q_tables)} sites, not 28")
    q.transcribe_batch(signals)                        # warm-up
    texts, launches = counted(q)                       # the int8 path
    print(f"int8 path: launches {launches}")
    check(launches == {"frontend_fp64": forwards, "frontend_fast": 0,
                       "repeat_block": 0},
          f"int8 path launches {launches} for {forwards} forwards")
    agree = [agreement(q.log_probs(s)[0], lp)
             for s, lp in zip(signals, base_lp)]
    same = sum(a == b for a, b in zip(texts, base_texts))
    print(f"int8 path vs the bf16 float route: frame argmax agreement mean "
          f"{np.mean(agree):.4f}, min {min(agree):.4f} (min "
          f"{INT8_ARGMAX_MIN}); transcripts equal {same}/{len(texts)}")
    check(min(agree) >= INT8_ARGMAX_MIN, "int8 path: argmax agreement "
          f"{min(agree)} < {INT8_ARGMAX_MIN}")
    path_numbers(np, torch, q, signals, "int8 path end to end")

    # the int8 GEMM at every site of the B = 8 x 16.7 s forward, on the
    # forward's own operands, against the exact GEMM
    full = signals[:8]
    batch = np.zeros((8, q.buckets[-1]), np.float32)
    for row, s in enumerate(full):
        batch[row, :len(s)] = s
    lens = torch.tensor([len(s) for s in full], dtype=torch.int32,
                        device=dev)
    sites = []

    def held(x_i8, w_i8):
        got = int8_matmul(x_i8, w_i8)
        want = int8_matmul_plain(x_i8, w_i8)
        sites.append((tuple(x_i8.shape), tuple(w_i8.shape),
                      int((got != want).sum())))
        return got

    with torch.inference_mode():
        feats, flens = q._featurize(torch.from_numpy(batch).to(dev), lens)
        quartznet_apply(q.variables, feats, flens, cfg=q.cfg.encoder,
                        compute_dtype=q.compute_dtype,
                        pw_fn=int8_pw_fn(q._q_tables, matmul=held))
    torch.cuda.synchronize()
    shapes = sorted({(x[0], x[1], w[1]) for x, w, _ in sites})
    bad = sum(n for _, _, n in sites)
    print(f"int8 GEMM (torch._int_mm) vs the exact GEMM at the "
          f"{len(sites)} sites of the B=8 x 16.7 s forward, (M, K, N) "
          f"{shapes}: {bad} elements differ")
    check(len(sites) == 28 and bad == 0,
          f"int8 GEMM: {len(sites)} sites, {bad} elements differ")
    return fast_launches


def train_word_lms(tmpdir):
    """Word 3- and 5-gram ARPA files over VI_CORPUS + the manifest texts,
    and the 3-gram as KenLM PROBING and TRIE binaries (keys "probing",
    "trie"), written by the port's writers."""
    from vietasr_tpu_torch.ops.kenlm_binary import write_kenlm_binary
    from vietasr_tpu_torch.ops.kenlm_trie import write_kenlm_trie
    from vietasr_tpu_torch.ops.lm import train_ngram_arpa

    with open(MANIFEST, encoding="utf-8") as f:
        refs = [json.loads(line)["text"].strip() for line in f]
    paths = {}
    for order in (3, 5):
        paths[order] = os.path.join(tmpdir, f"vi_word{order}.arpa")
        train_ngram_arpa(VI_CORPUS + refs, paths[order], order=order)
    paths["probing"] = os.path.join(tmpdir, "vi_word3.probing.binary")
    paths["trie"] = os.path.join(tmpdir, "vi_word3.trie.binary")
    write_kenlm_binary(paths[3], paths["probing"])
    write_kenlm_trie(paths[3], paths["trie"])
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
                       "beam_search": 1},
          f"beam path launches {launches} for {forwards} forwards and one "
          f"transcribe_batch call")
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
    # the same LM from its KenLM PROBING binary
    from_binary = Transcriber(CONFIG, checkpoint=ANCHOR,
                              options=TranscriberOptions(
                                  decoder="device_beam",
                                  lm_path=lm_paths["probing"]))
    binary_texts = from_binary.transcribe_batch(signals)
    same = sum(a == b for a, b in zip(binary_texts, texts))
    print(f"device beam from the PROBING binary vs the ARPA: transcripts "
          f"equal {same}/{len(texts)}")
    check(same == len(texts), "device beam transcripts from the KenLM "
          "binary differ from the ARPA's")
    del from_binary

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


def beam_bound_ms(lens, t_max, v1, k_c, w, n_cols, lm_rows, levels):
    """Least time for the beam search on these inputs: the larger of its
    bytes (log-probs and top-K in, start state in, backpointers and final
    state out, the LM table once) at 3.35 TB/s and its operations at the
    fp32 rate, counted per valid frame of each row as the least work the
    search needs: expand ~6 per candidate (base select, add, two hash
    multiply-adds), the merge ~8 per stay (a hash lookup of its parent and
    one compare of the chain), ~16 per beam for its stay terms, ~11 per LM
    chain (its key, and the one row a probe reads before it stops at a hit
    or an empty row), a top-W select linear in the candidates (~2 each: a
    key and a compare with a threshold), ~20 per new slot."""
    bsz = int(lens.shape[0])
    steps = int(lens.sum())
    nbytes = (4 * bsz * t_max * v1 + 8 * bsz * t_max * k_c
              + 8 * t_max * bsz * w + 2 * 4 * bsz * w * n_cols
              + 16 * lm_rows + 16 * levels + 4 * bsz)
    per_step = (6 * w * k_c + 8 * w + 16 * w + 11 * w * levels
                + 2 * w * (k_c + 1) + 20 * w)
    t_ops = steps * per_step / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), steps * per_step, nbytes


def synthetic_beam_inputs(np, torch, dev, v1, bsz=8, t_max=840):
    """Seeded blank-heavy (B, T, V+1) log-probs with ragged lengths (row 0
    full): the beam kernel's timing shape. Returns (log_probs, lengths,
    the logits they came from)."""
    rng = np.random.RandomState(2024)
    logits = rng.randn(bsz, t_max, v1).astype(np.float32) * 3.0
    logits[:, :, v1 - 1] += 2.0                       # blank-heavy, as CTC
    lp = torch.log_softmax(torch.from_numpy(logits), -1).to(dev)
    lens = rng.randint(t_max // 2, t_max + 1, size=bsz).astype(np.int32)
    lens[0] = t_max
    return lp, torch.from_numpy(lens).to(dev), logits


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
    for order in (3, 5):                 # the ARPA word 3- and 5-grams
        t, probes = word_lm_tables(NGramLM(lm_paths[order]), labels)
        tables[order] = (word_lm_to_device(t, dev), probes)
    v1, space = len(labels) + 1, labels.index(" ")
    synth_lp, synth_lens, logits = synthetic_beam_inputs(np, torch, dev, v1)
    bsz, t_max = synth_lp.shape[:2]
    # tie-heavy: logits on a 0.25 grid, so that many candidate totals tie
    # and the select's index tie-break decides the slot order
    tie_lp = torch.log_softmax(torch.from_numpy(
        np.round(logits * 4.0) / 4.0), -1).to(dev)
    inputs = {"synthetic": (synth_lp, synth_lens),
              "anchor": (anchor_lp, anchor_lens),
              "ties": (tie_lp, synth_lens)}
    cases = [(None, 16, n) for n in ("synthetic", "anchor")] \
        + [(o, w, n) for o in (3, 5) for w in (16, 50, 100)
           for n in ("synthetic", "anchor")] + [(3, 100, "ties")]

    worst = 0.0
    for order, w, name in cases:
        wl, probes = tables[order] if order else (None, 8)
        kw = dict(beam_width=w, space=space, word_lm=wl, wlm_probes=probes,
                  **BEAM_KW)
        fin = dict(word_lm=wl, alpha=BEAM_KW["alpha"], beta=BEAM_KW["beta"],
                   wlm_probes=probes)
        lp, lens = inputs[name]
        raw_k = fused_beam_search(lp, lens, blank=v1 - 1, return_raw=True,
                                  **kw)
        raw_p = device_beam_search(lp, lens, blank=v1 - 1, return_raw=True,
                                   **kw)
        torch.cuda.synchronize()
        raw_equal = all(torch.equal(a, b) for a, b in zip(raw_k, raw_p))
        best_k = packed_beam_totals(raw_k[0], **fin).amax(dim=1)
        best_p = packed_beam_totals(raw_p[0], **fin).amax(dim=1)
        err = float((best_k - best_p).abs().max())
        worst = max(worst, err)
        ids, n = best_path_from_raw(*raw_k, **fin)
        print(f"beam {name} B={lp.shape[0]} W={w} LM {order or 'none'}: "
              f"raw state/backpointers equal {raw_equal}, max |d best total|"
              f" {err:.3e}; first text {render(labels, ids, n)[0][:40]!r}")
        check(bool(torch.isfinite(best_k).all()), "beam: non-finite")
        check(raw_equal, f"beam {name} W={w} LM {order}: the raw result "
              "differs from the plain device_beam_search")

    # times at the bound's shape: B = 8, T = 840, W = 100, word 3-gram
    wl, probes = tables[3]
    w = 100
    k_c = expansion_width(v1 - 1, BEAM_KW["cutoff_top_n"])
    top_lp, top_ci = frame_topk(synth_lp, k_c)
    state = init_packed_state(bsz, w, wl, dev)
    kern = dict(blank=v1 - 1, space=space, alpha=BEAM_KW["alpha"],
                beta=BEAM_KW["beta"], word_lm=wl, wlm_probes=probes)
    ms, seen, ev_ms = kernel_ms(lambda: beam_search_cuda(
        synth_lp, synth_lens, top_lp, top_ci, state, **kern), "beam_kernel",
        reps=10)
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
        int(wl.masks.shape[0]))
    # the barriers the kernel's steps took and the keys >= its threshold
    # they ranked, counted by the kernel in this run
    stats = torch.zeros((bsz, 2), dtype=torch.int64, device=dev)
    beam_search_cuda(synth_lp, synth_lens, top_lp, top_ci, state,
                     stats=stats, **kern)
    steps = int(synth_lens.sum())
    barriers = int(stats[:, 0].sum()) / steps
    ranked = int(stats[:, 1].sum()) / steps
    check(5 * steps <= int(stats[:, 0].sum()) <= 6 * steps,
          f"beam kernel counted {int(stats[:, 0].sum())} barriers over "
          f"{steps} steps")
    us_step = ms / t_max * 1e3       # the longest row's T steps, in series
    print(f"beam kernel B={bsz} T={t_max} W={w} K={k_c} word 3-gram "
          f"({wl.packed.shape[0]} table rows, {probes} probes): {ms:.4f} ms "
          f"({us_step:.3f} us per step; {barriers:.4f} barriers and "
          f"{ranked:.1f} of {w * (k_c + 1)} keys ranked per step, counted by "
          f"the kernel over {steps} steps; "
          f"{seen:g} traced per call, events {ev_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms device ({plain_wall:.1f} ms wall), bound "
          f"{bound:.4f} ms by {bound_by} ({ops / 1e9:.3f} G operations, "
          f"{nbytes / 1e6:.2f} MB); the {t_max} steps run one after another")
    return {"name": "beam_search", "route": "cuda",
            "source": "vietasr_tpu_torch/csrc/beam_search.cu",
            "replaces": "vietasr_tpu/ops/pallas_beam.py:325",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "us_per_step": us_step, "barriers_per_step": barriers}


def host_beam_phase(np, torch, signals, lm_paths, tmpdir):
    """Phase 6b: the host beam path, Transcriber(decoder="beam"), with the
    word 3-gram from its PROBING binary, counters read around the run."""
    from scipy.io import wavfile

    from vietasr_tpu_torch.audio.g711 import ulaw_encode
    from vietasr_tpu_torch.audio.io import read_audio
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.models.convert import (load_anchor,
                                                  state_dict_from_variables)
    from vietasr_tpu_torch.ops.beam_search import BeamSearchDecoderLM
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    tr = Transcriber(CONFIG, checkpoint=ANCHOR, options=TranscriberOptions(
        decoder="beam", lm_path=lm_paths["probing"]))
    labels, width = tr.cfg.labels, tr.opts.beam_width
    check(tr._decoder is not None and tr._decoder._native is not None,
          "the host beam decoder did not take the C++ tier")
    tr.transcribe_batch(signals)                       # warm-up
    batches = forward_batches(np, torch, tr, signals)
    forwards = len(batches)

    fused_log_mel_features.launches = 0
    fused_repeat_block.launches = 0
    fused_beam_search.launches = 0
    texts = tr.transcribe_batch(signals)               # the host beam path
    launches = {"log_mel_frontend": fused_log_mel_features.launches,
                "repeat_block": fused_repeat_block.launches,
                "beam_search": fused_beam_search.launches}
    print(f"host beam path (W={width}, word 3-gram, PROBING binary): "
          f"{len(signals)} signals, {forwards} forwards, launches {launches}")
    check(launches == {"log_mel_frontend": forwards,
                       "repeat_block": 13 * forwards, "beam_search": 0},
          f"host beam path launches {launches} for {forwards} forwards")
    check(all(isinstance(t, str) for t in texts) and any(texts),
          "host beam path: no transcript")

    # the same log-probs on the host through the C++ tier, the LM from the
    # ARPA and from the TRIE binary
    host = [(group, lp.float().cpu().numpy(), el.cpu().numpy())
            for group, lp, el in batches]
    for kind, name in ((3, "ARPA"), ("trie", "TRIE binary")):
        dec = BeamSearchDecoderLM(labels, lm_path=lm_paths[kind],
                                  beam_width=width)
        other = [None] * len(signals)
        for group, lp, el in host:
            for row, text in zip(group, dec.decode_batch(lp, el)):
                other[row] = text
        same = sum(a == b for a, b in zip(texts, other))
        print(f"host beam path vs the C++ tier from the {name}: transcripts "
              f"equal {same}/{len(texts)}")
        check(same == len(texts), f"host beam transcripts differ from the "
              f"C++ tier's with the {name}")

    # the 4 shortest signals at W = 16: the C++ tier vs the Python tier
    short = sorted(range(len(signals)), key=lambda i: len(signals[i]))[:4]
    tr16 = Transcriber(CONFIG, checkpoint=ANCHOR, options=TranscriberOptions(
        decoder="beam", lm_path=lm_paths["probing"], beam_width=16))
    native16 = tr16.transcribe_batch([signals[i] for i in short])
    python = BeamSearchDecoderLM(labels, lm_path=lm_paths["probing"],
                                 beam_width=16, use_native=False)
    t0 = time.perf_counter()
    py16 = [python.decode_batch(*tr16.log_probs(signals[i]))[0]
            for i in short]
    py_s = time.perf_counter() - t0
    same = sum(a == b for a, b in zip(native16, py16))
    print(f"host beam W=16, 4 shortest signals: C++ tier vs Python tier "
          f"transcripts equal {same}/4 (Python tier {py_s:.2f} s)")
    check(same == 4, "the C++ and Python tiers differ at W = 16")
    del tr16

    # the numbers: wall per call, the host decode inside it, the card
    decode_s = []
    decode_batch = tr._decoder.decode_batch

    def timed_decode(lp, lens):
        t = time.perf_counter()
        out = decode_batch(lp, lens)
        decode_s.append(time.perf_counter() - t)
        return out

    tr._decoder.decode_batch = timed_decode
    audio_s = sum(len(s) for s in signals) / 16000
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.transcribe_batch(signals)
    dt = (time.perf_counter() - t0) / reps
    dec_ms = sum(decode_s) / reps * 1e3
    tr._decoder.decode_batch = decode_batch
    print(f"host beam path end to end: {audio_s:.1f} audio-s in "
          f"{dt * 1e3:.2f} ms = {audio_s / dt:.1f} audio-s/s; host decode "
          f"(decode_batch, C++ tier) {dec_ms:.2f} ms per call over "
          f"{len(decode_s) // reps} decode_batch calls; the rest (forwards, "
          f"copies to the host) {dt * 1e3 - dec_ms:.2f} ms")
    rows = device_profile(lambda: tr.transcribe_batch(signals), reps=3)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile of the host beam path (16 signals): device busy "
          f"{busy_ms:.4f} ms of {dt * 1e3:.4f} ms wall ("
          f"{100 * (1 - busy_ms / (dt * 1e3)):.1f} % idle)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.4f} ms  x{count:<4g} {key[:100]}")

    # the reference's NeMo .pt checkpoints, written from the anchor
    sd = state_dict_from_variables(load_anchor(ANCHOR), tr.cfg.encoder)
    enc_pt, dec_pt = (os.path.join(tmpdir, n) for n in (
        "JasperEncoder-STEP-0.pt", "JasperDecoderForCTC-STEP-0.pt"))
    for path, prefix in ((enc_pt, "encoder."), (dec_pt, "decoder_layers.")):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items() if k.startswith(prefix)}, path)
    from_pt = Transcriber(CONFIG, encoder_checkpoint=enc_pt,
                          decoder_checkpoint=dec_pt)
    worst = 0.0
    for s in signals[::4]:
        lp, el = from_pt.log_probs(s)
        lp_ref, el_ref = tr.log_probs(s)
        check(np.array_equal(el, el_ref) and lp.shape == lp_ref.shape
              and np.isfinite(lp).all(),
              "the .pt Transcriber: lengths, shape or finiteness")
        worst = max(worst, float(np.abs(lp - lp_ref).max()))
    print(f"Transcriber from the NeMo .pt files vs the anchor's: "
          f"max|d log p| {worst:.4e} (tol {E2E_LOGP_TOL})")
    check(worst <= E2E_LOGP_TOL, f"the .pt Transcriber's log-probs: {worst}")
    del from_pt

    # transcribe_file: a PCM16 WAV at 16 kHz and a mu-law WAV at 8 kHz
    rng = np.random.RandomState(77)
    pcm = os.path.join(tmpdir, "clip16k.wav")
    wavfile.write(pcm, 16000, (rng.randn(5 * 16000) * 0.1 * 32767)
                  .astype(np.int16))
    ulaw = os.path.join(tmpdir, "clip8k_ulaw.wav")
    codes = ulaw_encode((rng.randn(4 * 8000) * 0.1).astype(np.float32))
    fmt = (np.array([7, 1], "<u2").tobytes()           # mu-law, mono
           + np.array([8000, 8000], "<u4").tobytes()   # rate, bytes/s
           + np.array([1, 8], "<u2").tobytes())        # align, bits
    body = (b"WAVE" + b"fmt " + np.uint32(len(fmt)).tobytes() + fmt
            + b"data" + np.uint32(len(codes)).tobytes() + codes.tobytes())
    with open(ulaw, "wb") as f:
        f.write(b"RIFF" + np.uint32(len(body)).tobytes() + body)
    for path in (pcm, ulaw):
        samples, sr = read_audio(path, target_sr=16000)
        got, want = tr.transcribe_file(path), tr.transcribe(samples)
        print(f"transcribe_file({os.path.basename(path)}): {len(samples)} "
              f"samples at {sr} Hz, equal to transcribe: {got == want}")
        check(got == want, f"transcribe_file({path}) != transcribe")


def ctc_case(np, torch, dev, seed, ilen, tlen, t_max, num_classes=90,
             targets=None):
    """Seeded (B, T, V) log-probs (blank = num_classes) and random labels
    (or `targets`) -> the tensors both kernels take, on the card."""
    rng = np.random.RandomState(seed)
    bsz, v = len(ilen), num_classes + 1
    lp = torch.log_softmax(torch.from_numpy(
        (rng.randn(bsz, t_max, v) * 2).astype(np.float32)).to(dev), dim=-1)
    if targets is None:
        targets = rng.randint(0, num_classes,
                              size=(bsz, max(int(max(tlen)), 1)))
    targets = torch.from_numpy(np.asarray(targets, np.int64)).to(dev)
    ilen = torch.from_numpy(np.asarray(ilen, np.int32)).to(dev)
    tlen = torch.from_numpy(np.asarray(tlen, np.int32)).to(dev)
    return ctc_lattice(lp, targets, ilen, tlen, num_classes)


def ctc_lattice(lp, targets, ilen, tlen, blank):
    """(B, T, V) fp32 log-probs and (B, L) targets on the card -> the
    tensors both kernels take, built as ctc_loss builds them."""
    from vietasr_tpu_torch.ops.ctc_loss import emission_lookup, lattice_masks

    ext, can, valid = lattice_masks(targets, tlen, blank)
    lp_ext = emission_lookup(lp, ext).contiguous()
    return dict(lp=lp, targets=targets, ilen=ilen.int().contiguous(),
                tlen=tlen.int().contiguous(), lp_ext=lp_ext,
                can=can.contiguous(), valid=valid.contiguous())


def ctc_training_lengths(np):
    """Input and target lengths of the training shape (T = 840): 32
    utterances of 1.5-16.7 s, row 0 the longest, at 50 encoder frames and
    ~13 characters a second (S = 435); the lattice is ctc_case(np, torch,
    dev, 8, ilen, tlen, 840)."""
    rng = np.random.RandomState(7)
    secs = rng.uniform(1.5, 16.7, size=32)
    secs[0] = 16.7
    ilen = np.minimum((secs * 50).astype(np.int32), 840)
    tlen = np.round(secs * 13).astype(np.int32)
    return ilen, tlen


def ctc_compare(torch, c):
    """Both kernels against their plain versions on one case: (max |d ll|
    over feasible rows, max relative |d alpha|, max |d grad|, ll, the
    numbers of alpha, loss and gradient elements that differ from the plain
    versions'); fails unless all three numbers are 0."""
    from vietasr_tpu_torch.ops import fused_ctc as fc

    lat = (c["lp_ext"], c["can"], c["valid"], c["ilen"])
    bsz = c["lp_ext"].shape[0]
    a_k, a_p = fc.ctc_alpha_cuda(*lat), fc.ctc_alpha_plain(*lat)
    ll_k = fc.final_ll(a_k[:, -1], c["tlen"])
    ll_p = fc.final_ll(a_p[:, -1], c["tlen"])
    ybar = torch.linspace(0.5, 1.5, bsz, device=a_k.device)
    tail = (c["ilen"], c["tlen"])
    g_k = fc.ctc_beta_cuda(c["lp_ext"], a_k, c["can"], c["valid"], *tail,
                           ll_k, ybar)
    g_p = fc.ctc_beta_plain(c["lp_ext"], a_p, c["can"], c["valid"], *tail,
                            ll_p, ybar)
    torch.cuda.synchronize()
    feasible = ll_p > fc.NEG / 2
    check(bool(torch.equal(feasible, ll_k > fc.NEG / 2)),
          "ctc: kernel and plain disagree on which rows are feasible")
    d_ll = float((ll_k - ll_p)[feasible].abs().max())
    check(d_ll <= CTC_TOL * max(float(ll_p[feasible].abs().max()), 1.0),
          f"ctc: |d ll| {d_ll}")
    d_a = float(((a_k - a_p).abs() / a_p.abs().clamp_min(1.0)).max())
    d_g = float((g_k - g_p).abs().max())
    check(d_a <= CTC_TOL, f"ctc: relative |d alpha| {d_a}")
    check(d_g <= CTC_TOL, f"ctc: |d grad| {d_g}")
    check(bool(torch.isfinite(g_k).all()), "ctc: non-finite gradient")
    for b in range(bsz):
        check(not bool(g_k[b, max(int(c["ilen"][b]), 0):].any()),
              f"ctc: gradient past the input length in row {b}")
        if not bool(feasible[b]):
            check(not bool(g_k[b].any()),
                  f"ctc: infeasible row {b} has a gradient")
    differ = tuple(int((k != p).sum()) for k, p in
                   ((a_k, a_p), (ll_k, ll_p), (g_k, g_p)))
    check(differ == (0, 0, 0), f"ctc: (alpha, loss, gradient) elements "
          f"differing from the plain versions: {differ}")
    return d_ll, d_a, d_g, ll_k, differ


def ctc_bound_ms(ilen, tlen, t_max, s):
    """Least time for each kernel on these inputs: its operations over the
    cells the data needs (forward: frames 1..ilen-1 of each row's 2*tlen+1
    positions; backward: frames 0..ilen-1) at the fp32 rate, or its bytes
    (the needed lp_ext / alpha cells in, the whole (B, T, S) lattice or
    gradient out, the (B, S) gates and (B,) scalars)."""
    bsz = len(ilen)
    s_b = [2 * int(t) + 1 for t in tlen]
    n = [min(max(int(i), 1), t_max) for i in ilen]
    fwd_cells = sum((a - 1) * w for a, w in zip(n, s_b))
    bwd_cells = sum(a * w for a, w in zip(n, s_b))
    lattice = 4 * bsz * t_max * s
    gates = 2 * bsz * s
    out = []
    for ops, nbytes in ((CTC_ALPHA_OPS * fwd_cells,
                         4 * bwd_cells + lattice + gates + 4 * bsz),
                        (CTC_BETA_OPS * bwd_cells,
                         8 * bwd_cells + lattice + gates + 16 * bsz)):
        t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        out.append((max(t_ops, t_bytes),
                    "operations" if t_ops >= t_bytes else "bytes", ops,
                    nbytes))
    return out


def ctc_phase(np, torch, dev):
    """Phase 7: the CTC pair against its plain version, timed at the
    training shape, with F.ctc_loss as the library's yardstick."""
    import torch.nn.functional as F

    from vietasr_tpu_torch.ops import fused_ctc as fc
    from vietasr_tpu_torch.ops.ctc_loss import (ctc_loss, emission_lookup,
                                                lattice_masks)

    t_max = 840
    main_ilen, main_tlen = ctc_training_lengths(np)
    cases = {"training B=32 T=840 S=435": dict(
        seed=8, ilen=main_ilen, tlen=main_tlen, t_max=t_max)}
    edge_targets = np.zeros((6, 30), np.int64)
    edge_targets[0, :30] = [5] * 10 + [6, 6, 7, 7] * 5    # repeats
    edge_targets[1, :20] = np.arange(20)                   # infeasible
    edge_targets[3, :12] = [3, 3, 3, 3, 9, 9, 9, 9, 1, 1, 2, 2]
    edge_targets[4, :25] = np.arange(25) % 89
    edge_targets[5, :8] = [8, 8, 8, 8, 8, 8, 8, 8]
    cases["edges B=6 T=120"] = dict(
        seed=9, ilen=[120, 12, 60, 31, 77, 17], tlen=[30, 20, 0, 12, 25, 8],
        t_max=120, targets=edge_targets)
    cases["B=1 T=300"] = dict(seed=10, ilen=[300], tlen=[80], t_max=300)
    cases["S=1025 B=3 T=1100"] = dict(seed=11, ilen=[1100, 1090, 900],
                                      tlen=[512, 500, 300], t_max=1100)
    # the schedule's edges: T = 1, T below the prefetch ring's depth, input
    # lengths 0 and 1, every target empty (S = 1), the widest lattice
    cases["T=1 B=3"] = dict(seed=13, ilen=[1, 1, 1], tlen=[0, 1, 2], t_max=1)
    cases["T=3 B=4"] = dict(seed=14, ilen=[3, 2, 1, 3], tlen=[1, 2, 0, 1],
                            t_max=3)
    cases["lengths 0 and 1 B=4 T=50"] = dict(
        seed=15, ilen=[0, 1, 50, 25], tlen=[10, 0, 20, 8], t_max=50)
    cases["S=1 B=6 T=30"] = dict(seed=16, ilen=[30, 20, 1, 24, 0, 21],
                                 tlen=[0] * 6, t_max=30,
                                 targets=np.zeros((6, 0), np.int64))
    cases["S=4095 B=2 T=4200"] = dict(seed=17, ilen=[4200, 3000],
                                      tlen=[2047, 1500], t_max=4200)
    worst_ll = worst_g = 0.0
    for name, kw in cases.items():
        c = ctc_case(np, torch, dev, **kw)
        d_ll, d_a, d_g, ll, differ = ctc_compare(torch, c)
        infeasible = int((ll <= fc.NEG / 2).sum())
        worst_ll, worst_g = max(worst_ll, d_ll), max(worst_g, d_g)
        s = c["lp_ext"].shape[2]
        plans = [tuple(fc.device_plan(s, n, dev))[:3] for n in (1, 2)]
        print(f"ctc {name}: max|d loss| {d_ll:.3e}, max rel|d alpha| "
              f"{d_a:.3e}, max|d grad| {d_g:.3e} (tol {CTC_TOL}); "
              f"(alpha, loss, gradient) elements differing from the plain "
              f"versions {differ}; {infeasible} infeasible rows with zero "
              f"gradient; launch plans (positions a thread, threads, ring) "
              f"alpha {plans[0]}, beta {plans[1]}")
        if name.startswith("edges"):
            check(infeasible == 1, "ctc edges: want exactly 1 infeasible row")
        if name.startswith("training"):
            main = c

    # the loss through the autograd Function, kernels vs plain versions,
    # d loss / d log_probs through the emission lookup's transpose
    ext, can, valid = lattice_masks(main["targets"], main["tlen"], 90)
    grads = {}
    for plain in (False, True):
        x = main["lp"].detach().clone().requires_grad_(True)
        loss = fc.ctc_neg_ll(emission_lookup(x, ext), can, valid,
                             main["ilen"], main["tlen"], plain=plain)
        loss.mean().backward()
        grads[plain] = (loss.detach(), x.grad)
    d_fn = float((grads[False][1] - grads[True][1]).abs().max())
    check(torch.equal(grads[False][0], grads[True][0]) or float(
        (grads[False][0] - grads[True][0]).abs().max())
          <= CTC_TOL * float(grads[True][0].abs().max()),
          "ctc: Function losses differ")
    check(d_fn <= CTC_TOL, f"ctc: Function d/d log_probs differ by {d_fn}")
    # how right the gradient is: the kernels' analytic gradient and
    # autodiff through the fp32 scan, each against autodiff through an fp64
    # scan (see CTC_GRAD_FP64_RTOL)
    def scan_grad(dtype):
        x = main["lp"].detach().to(dtype).requires_grad_(True)
        ctc_loss(x, main["targets"], main["ilen"], main["tlen"], blank=90,
                 reduction="none", impl="plain").mean().backward()
        return x.grad

    g64 = scan_grad(torch.float64)
    err_kernel = float((grads[False][1] - g64).abs().max())
    err_scan = float((scan_grad(torch.float32) - g64).abs().max())
    print(f"ctc d loss / d log_probs vs an fp64 scan: kernels {err_kernel:.3e}"
          f", fp32 scan under autograd {err_scan:.3e} (max |grad| "
          f"{float(g64.abs().max()):.3e})")
    check(err_kernel <= CTC_GRAD_FP64_RTOL * float(g64.abs().max()),
          f"ctc: kernel gradient {err_kernel} from the fp64 scan's")
    # the library's CTC on the same (T, B, V) log-probs
    lp_tbv = main["lp"].transpose(0, 1).contiguous()
    lib_args = (main["targets"], main["ilen"].long(), main["tlen"].long())
    lib_kw = dict(blank=90, reduction="none", zero_infinity=True)
    want = F.ctc_loss(lp_tbv, *lib_args, **lib_kw)
    ours = grads[False][0]
    d_lib = float(((ours - want).abs() / want.abs().clamp_min(1.0)).max())
    check(d_lib <= CTC_LIBRARY_RTOL, f"ctc vs F.ctc_loss: rel {d_lib}")
    print(f"ctc Function kernels vs plain: max|d d/dlog_probs| {d_fn:.3e}; "
          f"loss vs F.ctc_loss: max rel {d_lib:.3e} (tol "
          f"{CTC_LIBRARY_RTOL})")

    # times at the training shape
    lat = (main["lp_ext"], main["can"], main["valid"], main["ilen"])
    alphas = fc.ctc_alpha_cuda(*lat)
    ll = fc.final_ll(alphas[:, -1], main["tlen"])
    ybar = torch.full_like(ll, 1.0 / 32)
    beta_args = (main["lp_ext"], alphas, main["can"], main["valid"],
                 main["ilen"], main["tlen"], ll, ybar)
    ms_a, seen_a, ev_a = kernel_ms(lambda: fc.ctc_alpha_cuda(*lat),
                                   "alpha_kernel")
    ms_b, seen_b, ev_b = kernel_ms(lambda: fc.ctc_beta_cuda(*beta_args),
                                   "beta_kernel")
    plain_a = device_ms(lambda: fc.ctc_alpha_plain(*lat), reps=3)
    plain_b = device_ms(lambda: fc.ctc_beta_plain(*beta_args), reps=3)
    lib_fwd = device_ms(lambda: F.ctc_loss(lp_tbv, *lib_args, **lib_kw))
    x = lp_tbv.detach().clone().requires_grad_(True)

    def lib_step():
        x.grad = None
        F.ctc_loss(x, *lib_args, **lib_kw).sum().backward()

    lib_both = device_ms(lib_step)
    # the floor of T dependent steps: one warp's worth of lattice (B = 1,
    # S = 3) over the same T, nothing to overlap with
    tiny = ctc_case(np, torch, dev, 12, [t_max], [1], t_max)
    tiny_lat = (tiny["lp_ext"], tiny["can"], tiny["valid"], tiny["ilen"])
    tiny_a = fc.ctc_alpha_cuda(*tiny_lat)
    tiny_ll = fc.final_ll(tiny_a[:, -1], tiny["tlen"])
    floor_a = kernel_ms(lambda: fc.ctc_alpha_cuda(*tiny_lat),
                        "alpha_kernel")[0]
    floor_b = kernel_ms(lambda: fc.ctc_beta_cuda(
        tiny["lp_ext"], tiny_a, tiny["can"], tiny["valid"], tiny["ilen"],
        tiny["tlen"], tiny_ll, torch.ones_like(tiny_ll)), "beta_kernel")[0]
    s = main["lp_ext"].shape[2]
    (bound_a, by_a, ops_a, bytes_a), (bound_b, by_b, ops_b, bytes_b) = \
        ctc_bound_ms(main_ilen, main_tlen, t_max, s)
    for name, ms, seen, ev, plain_ms, bound, by, ops, nbytes, floor in (
            ("alpha", ms_a, seen_a, ev_a, plain_a, bound_a, by_a, ops_a,
             bytes_a, floor_a),
            ("beta", ms_b, seen_b, ev_b, plain_b, bound_b, by_b, ops_b,
             bytes_b, floor_b)):
        print(f"ctc {name} kernel B=32 T={t_max} S={s}: {ms:.4f} ms ({seen:g}"
              f" traced per call; events {ev:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {by} "
              f"({ops / 1e6:.1f} M operations, {nbytes / 1e6:.2f} MB); "
              f"sequential floor (B=1, S=3, same T) {floor:.4f} ms")
    print(f"F.ctc_loss B=32 T={t_max}: forward {lib_fwd:.4f} ms, forward + "
          f"backward {lib_both:.4f} ms")
    common = {"route": "cuda", "source": "vietasr_tpu_torch/csrc/ctc.cu",
              "launches": 0}
    return [dict(common, name="ctc_alpha",
                 replaces="vietasr_tpu/ops/pallas_ctc.py:51",
                 max_abs_err=worst_ll, ms=ms_a, plain_ms=plain_a,
                 bound_ms=bound_a, bound_by=by_a, library_ms=lib_fwd,
                 sequential_floor_ms=floor_a),
            dict(common, name="ctc_beta",
                 replaces="vietasr_tpu/ops/pallas_ctc.py:76",
                 max_abs_err=worst_g, ms=ms_b, plain_ms=plain_b,
                 bound_ms=bound_b, bound_by=by_b,
                 library_ms=lib_both - lib_fwd, sequential_floor_ms=floor_b)]


# ---------------------------------------------------------------------------
# phase 9: long-form; phase 10: streaming serving

CAUSAL_CONFIG = os.path.join(HERE, "vietasr_tpu_torch", "configs",
                             "quartznet12x1_vi_causal.yaml")
CAUSAL_ANCHOR = os.path.join(HERE, "artifacts",
                             "real_speech_qn12x1_vi_causal.msgpack.gz")
# long-form signals at 16 kHz float32, seconds
LONGFORM_SECONDS = (45, 90, 180, 300)
# long-form kernel route vs plain route (bf16): frame argmax agreement of
# the stitched log-probs, phase 5's kind of bound (E2E_LOGP_TOL beside it)
LONGFORM_ARGMAX_MIN = 0.99
# device int16 / G.711 conversion + polyphase resampling vs the host path
# (audio/g711.py, scipy's resample_poly): the same fp32 taps summed in
# another order, on signals of |x| <= ~0.5
RESAMPLE_TOL = 1e-5
# phase 10's streamer vs the offline forward: on a narrow model with no
# normalization, the JAX package's streaming contract, 1e-4 in log p
STREAM_TOL = 1e-4
# on the trained causal anchor at full width no fp32 forward meets that:
# the causal stats of the first frames divide by the std of a few frames
# (+ 1e-2), so how far an fp32 forward lies from an exact one depends on
# the signal. So the stream is held against an fp64 offline forward on
# the card, no further from it, in p and in log p, than this factor times
# the fp32 offline forward on the same input (both distances printed)
STREAM_ANCHOR_FACTOR = 2.0
POOL_CHUNK = 3200


def longform_signals(np):
    """Seeded noise x 0.1: 45, 90, 180 and 300 s at 16 kHz float32, 300 s
    of 8 kHz int16 PCM and 120 s of 8 kHz mu-law bytes."""
    from vietasr_tpu_torch.audio.g711 import ulaw_encode

    rng = np.random.RandomState(909)
    sigs = [(rng.randn(s * 16000) * 0.1).astype(np.float32)
            for s in LONGFORM_SECONDS]
    pcm8 = (rng.randn(300 * 8000) * 0.1 * 32767).astype(np.int16)
    ulaw8 = ulaw_encode((rng.randn(120 * 8000) * 0.1).astype(np.float32))
    return sigs, pcm8, ulaw8


def reset_launches():
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block

    for f in (fused_log_mel_features, fused_repeat_block, fused_beam_search):
        f.launches = 0


def read_launches() -> dict:
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block

    return {"log_mel_frontend": fused_log_mel_features.launches,
            "repeat_block": fused_repeat_block.launches,
            "beam_search": fused_beam_search.launches}


def add_path_launches(kernels, path: str, launches: dict) -> None:
    for k in kernels:
        if k["name"] in launches:
            k.setdefault("path_launches", {})[path] = launches[k["name"]]


def hold_frontend(torch, cfg, sig, lens, feats, flens, what) -> float:
    """The frontend kernel's output on a path (feats, flens) against its
    plain version on the same signals; returns max|d|."""
    from vietasr_tpu_torch.frontend.cuda_frontend import (
        fused_log_mel_features_plain)

    want, want_len = fused_log_mel_features_plain(sig, lens, cfg=cfg)
    check(feats.shape == want.shape and bool((flens == want_len).all())
          and bool(torch.isfinite(feats).all()),
          f"{what}: frontend shape, seq_len or finiteness")
    err = float((feats - want).abs().max())
    check(err < FRONTEND_TOL, f"{what}: frontend max|d| {err}")
    return err


def record_repeat_calls(qn):
    """Wrap the encoder's repeat-block entry point: returns (calls, undo);
    each call's (args, kwargs, output) is appended to calls."""
    calls, real = [], qn.fused_repeat_block

    def record(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    qn.fused_repeat_block = record

    def undo():
        qn.fused_repeat_block = real

    return calls, undo


def hold_repeat(calls, what) -> float:
    """Each recorded repeat-block call against its plain version on the
    same inputs, within REPEAT_TOL_REL of the largest output; returns the
    worst max|d| / max|want|."""
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block_plain

    worst = 0.0
    for args, kw, got in calls:
        want = fused_repeat_block_plain(*args, **kw)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        check(err <= REPEAT_TOL_REL * scale, f"{what}: repeat "
              f"{tuple(args[0].shape)} max|d| {err} > {REPEAT_TOL_REL} * "
              f"{scale}")
        worst = max(worst, err / scale)
    return worst


def conversion_checks(np, torch, dev, pcm8, ulaw8):
    """Device G.711 / int16 decode and resampling vs the host path, TF32 off
    (this script's setting) and at PyTorch's defaults (cuDNN TF32 on)."""
    from vietasr_tpu_torch.audio import g711 as host_g711
    from vietasr_tpu_torch.audio.io import resample
    from vietasr_tpu_torch.ops.g711 import decode_wire
    from vietasr_tpu_torch.ops.resample import make_device_resampler

    codes = np.arange(256, dtype=np.uint8)
    for law in ("ulaw", "alaw"):
        got = decode_wire(torch.from_numpy(codes).to(dev), law).cpu().numpy()
        want = getattr(host_g711, f"{law}_decode")(codes).astype(
            np.float32) / 32768.0
        check(np.array_equal(got, want), f"device {law} decode differs from "
              "the host codec")
    res = make_device_resampler(8000, 16000, device=dev)
    cases = {"int16 8 kHz 300 s": (pcm8, pcm8.astype(np.float32) / 32768.0),
             "mu-law 8 kHz 120 s": (ulaw8, host_g711.ulaw_decode(ulaw8)
                                    .astype(np.float32) / 32768.0)}
    worst = 0.0
    for tf32 in (False, True):
        old = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            for what, (wire, host) in cases.items():
                want = resample(host, 8000, 16000)
                got = res(decode_wire(torch.from_numpy(wire).to(dev),
                                      "ulaw")).cpu().numpy()
                err = float(np.abs(got - want).max())
                worst = max(worst, err)
                print(f"long-form {what}: device decode + resample vs host "
                      f"max|d| {err:.3e} (tol {RESAMPLE_TOL}; cuDNN TF32 "
                      f"flag {'on, PyTorch default' if tf32 else 'off'})")
                check(got.shape == want.shape and err <= RESAMPLE_TOL,
                      f"{what}: device conversion vs host {err}")
        finally:
            torch.backends.cudnn.allow_tf32 = old
    wire = torch.from_numpy(pcm8).to(dev)
    ms = device_ms(lambda: res(decode_wire(wire)), reps=5)
    print(f"device int16 decode + 8 -> 16 kHz resample of 300 s: {ms:.4f} "
          f"ms (CUPTI)")
    return worst


def longform_phase(np, torch, dev, lm_paths, kernels):
    """Phase 9: transcribe_long_batch (greedy) over 6 long signals, the
    device beam and host beam on one, each kernel against its plain
    version at the long-form shapes."""
    import vietasr_tpu_torch.models.quartznet as qn
    from vietasr_tpu_torch import streaming as lf
    from vietasr_tpu_torch.models.convert import load_anchor
    from vietasr_tpu_torch.ops.device_beam import device_beam_search
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    sigs, pcm8, ulaw8 = longform_signals(np)
    audio_s = sum(len(s) for s in sigs) / 16000 + (len(pcm8)
                                                   + len(ulaw8)) / 8000
    tr = Transcriber(CONFIG, checkpoint=ANCHOR)
    ref = Transcriber(CONFIG, variables=load_anchor(ANCHOR),
                      options=TranscriberOptions(fused_frontend="off",
                                                 block_impl="plain"))
    inputs = [(s, None, None) for s in sigs] + [(pcm8, 8000, None),
                                                (ulaw8, 8000, "ulaw")]

    def run(t):
        return (t.transcribe_long_batch(sigs)
                + t.transcribe_long_batch([pcm8], signal_sr=8000)
                + t.transcribe_long_batch([ulaw8], signal_sr=8000,
                                          signal_encoding="ulaw"))

    chunk, overlap, _ = lf._longform_grid(tr, 15.0, 2.0)
    preps = [lf._prep_longform(tr, x, sr, chunk, overlap, enc)
             for x, sr, enc in inputs]
    spans = [p[0] for p in preps]
    run(tr)                                            # warm-up
    torch.cuda.synchronize()
    reset_launches()
    texts = run(tr)                                    # the long-form path
    launches = read_launches()
    n = len(inputs)
    secs = [round(len(x) / (sr or 16000)) for x, sr, _ in inputs]
    print(f"long-form path: {n} utterances of {secs} s ({spans} spans of "
          f"15 s), launches "
          f"{launches}: per call {launches['log_mel_frontend'] / n:g} "
          f"frontend, {launches['repeat_block'] / n:g} repeat, "
          f"{launches['beam_search'] / n:g} beam")
    check(launches == {"log_mel_frontend": n, "repeat_block": 13 * n,
                       "beam_search": 0},
          f"long-form launches {launches} for {n} utterances")
    add_path_launches(kernels, "longform_greedy", launches)

    # the kernel route vs the plain route on the card: stitched log-probs
    ref_texts = run(ref)
    agree, worst_lp = [], 0.0
    for prep in preps:
        lp, total = lf._run_fused(tr, prep, chunk, overlap, True)
        lp_ref, total_ref = lf._run_fused(ref, prep, chunk, overlap, True)
        check(int(total) == int(total_ref) and lp.shape == lp_ref.shape,
              "long-form: stitched lengths differ from the plain route")
        t = int(total)
        check(bool(torch.isfinite(lp[:t]).all()), "long-form: non-finite")
        agree.append(float((lp[:t].argmax(-1) == lp_ref[:t].argmax(-1))
                           .float().mean()))
        worst_lp = max(worst_lp, float((lp[:t] - lp_ref[:t]).abs().max()))
    same = sum(a == b for a, b in zip(texts, ref_texts))
    print(f"long-form kernel route vs plain route: frame argmax agreement "
          f"min {min(agree):.4f} (bound {LONGFORM_ARGMAX_MIN}), max|d log p| "
          f"{worst_lp:.4e} (tol {E2E_LOGP_TOL}); transcripts equal "
          f"{same}/{n}")
    check(min(agree) >= LONGFORM_ARGMAX_MIN and worst_lp <= E2E_LOGP_TOL,
          f"long-form kernel vs plain route: agreement {agree}, "
          f"max|d| {worst_lp}")
    conversion_checks(np, torch, dev, pcm8, ulaw8)

    # the repeat kernel at the long-form batch (B = 27 rows of 15 s) vs
    # its plain version, inputs captured from the forward
    calls, undo = record_repeat_calls(qn)
    try:
        lf._run_fused(tr, preps[3], chunk, overlap, True)
    finally:
        undo()
    worst_rep = hold_repeat(calls, "long-form")
    rep_ms, seen, _ = kernel_ms(
        lambda: lf._run_fused(tr, preps[3], chunk, overlap, True),
        "repeat_kernel", reps=5, launches=13)
    print(f"long-form repeat kernel, 13 launches at B={spans[3]} x "
          f"T={tuple(calls[0][0][0].shape)[1]} (300 s): max|d| / max|want| "
          f"{worst_rep:.3e} (tol {REPEAT_TOL_REL:.3e}), {rep_ms:.4f} ms "
          f"({seen:g} traced per call)")
    check(len(calls) == 13, f"long-form forward made {len(calls)} repeat "
          "launches, not 13")

    torch.cuda.synchronize()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        run(tr)
    dt = (time.perf_counter() - t0) / reps
    rows = device_profile(lambda: run(tr), reps=1)
    busy = sum(r[0] for r in rows)
    idle = 1 - busy / (dt * 1e3)
    print(f"long-form end to end: {audio_s:.1f} audio-s in {dt * 1e3:.2f} ms "
          f"= {audio_s / dt:.1f} audio-s/s; device busy {busy:.4f} ms "
          f"({100 * idle:.1f} % idle)")
    for ms, count, key in rows[:8]:
        print(f"  {ms:8.4f} ms  x{count:<4g} {key[:100]}")

    # device beam (W = 100, word 3-gram) on the 90 s signal
    bt = Transcriber(CONFIG, checkpoint=ANCHOR, options=TranscriberOptions(
        decoder="device_beam", lm_path=lm_paths[3]))
    bt.transcribe_long(sigs[1])                        # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    beam_text = bt.transcribe_long(sigs[1])            # the device beam path
    dt_b = time.perf_counter() - t0
    launches = read_launches()
    print(f"long-form device beam (W={bt.opts.beam_width}, word 3-gram), "
          f"90 s: {dt_b * 1e3:.2f} ms = {90 / dt_b:.1f} audio-s/s, launches "
          f"{launches}, {len(beam_text)} characters")
    check(launches == {"log_mel_frontend": 1, "repeat_block": 13,
                       "beam_search": 1},
          f"long-form device beam launches {launches}")
    add_path_launches(kernels, "longform_device_beam", launches)
    # the beam kernel at a long-form shape (B = 1, 45 s: T = 2,250) vs
    # the plain search, raw result bit for bit
    lp, total = lf._run_fused(bt, preps[0], chunk, overlap, True)
    labels = bt.cfg.labels
    kw = dict(blank=len(labels), beam_width=bt.opts.beam_width,
              word_lm=bt._device_word_lm, wlm_probes=bt._device_wlm_probes,
              space=labels.index(" "), return_raw=True, **BEAM_KW)
    lens = total.reshape(1).to(torch.int32)
    got = fused_beam_search(lp[None].contiguous(), lens, **kw)
    t0 = time.perf_counter()
    want = device_beam_search(lp[None].contiguous(), lens, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"long-form beam kernel B=1 T={int(total)} (45 s) vs plain "
          f"device_beam_search: raw result equal bit for bit: {same} "
          f"(plain {plain_s:.1f} s wall)")
    check(same, "long-form beam kernel differs from the plain search")

    # the host beam on the 90 s signal
    hb = Transcriber(CONFIG, checkpoint=ANCHOR, options=TranscriberOptions(
        decoder="beam", lm_path=lm_paths["probing"]))
    hb.transcribe_long(sigs[1])                        # warm-up, C++ build
    reset_launches()
    t0 = time.perf_counter()
    host_text = hb.transcribe_long(sigs[1])
    dt_h = time.perf_counter() - t0
    launches = read_launches()
    lp_h, total_h = lf._run_fused(hb, preps[1], chunk, overlap, True)
    check(host_text == hb._decoder.decode(
        lp_h[:int(total_h)].float().cpu().numpy()),
        "long-form host beam: not the decode of the stitched log-probs")
    print(f"long-form host beam (W={hb.opts.beam_width}, PROBING), 90 s: "
          f"{dt_h * 1e3:.2f} ms = {90 / dt_h:.1f} audio-s/s, launches "
          f"{launches}")
    check(launches == {"log_mel_frontend": 1, "repeat_block": 13,
                       "beam_search": 0},
          f"long-form host beam launches {launches}")


def pool_schedule(np, chunk=POOL_CHUNK):
    """8 streams of 5-20 s opening 3 ticks apart: (start tick, mu-law
    chunks of `chunk` samples, true length)."""
    from vietasr_tpu_torch.audio.g711 import ulaw_encode

    rng = np.random.RandomState(1010)
    out = []
    for i in range(8):
        n = int(rng.uniform(5.0, 20.0) * 16000)
        codes = ulaw_encode((rng.randn(n) * 0.1).astype(np.float32))
        pad = np.concatenate([codes, np.full((-n) % chunk, 0xFF,
                                             np.uint8)])
        out.append((3 * i, [pad[j:j + chunk]
                            for j in range(0, len(pad), chunk)], n))
    return out


def drive_pools(pools, schedule, on_tick=None, chunk=POOL_CHUNK):
    """Feed `schedule` to every pool in lockstep (a stream's last chunk as
    the tail step at its true end, then its flush); on_tick() after each
    step of all pools. Returns each pool's (pieces, final texts)."""
    logs = [([], []) for _ in pools]
    slots = [{} for _ in pools]
    n_ticks = max(s + len(c) for s, c, _ in schedule)

    def step(fn):
        for p, (pool, log) in enumerate(zip(pools, logs)):
            log[0].append(fn(p, pool))
        if on_tick:
            on_tick()

    for tick in range(n_ticks):
        for i, (start, _, _) in enumerate(schedule):
            if tick == start:
                for p, pool in enumerate(pools):
                    slots[p][i] = pool.open()
        feed, tails, treal = {}, [], {}
        for i, (start, chunks, n) in enumerate(schedule):
            j = tick - start
            if 0 <= j < len(chunks):
                feed[i] = chunks[j]
                if j == len(chunks) - 1 and n % chunk:
                    tails.append(i)
                    treal[i] = n - j * chunk
        step(lambda p, pool: pool.feed(
            {slots[p][i]: c for i, c in feed.items()},
            tail_slots=tuple(slots[p][i] for i in tails),
            tail_real={slots[p][i]: r for i, r in treal.items()}))
        for i, (start, chunks, n) in enumerate(schedule):
            if tick - start == len(chunks) - 1:
                step(lambda p, pool: pool.flush(
                    slots[p][i], return_pieces=True,
                    tail_done=bool(n % chunk)))
                for p, pool in enumerate(pools):
                    logs[p][1].append(pool.close(slots[p][i]))
    return logs


def narrow_streaming_config():
    """The JAX package's streaming-test model: 4 narrow blocks over 16
    mels, no normalization, 3 labels."""
    from vietasr_tpu_torch.config import (BlockConfig, EncoderConfig,
                                          ModelConfig, SpecAugmentConfig)
    from vietasr_tpu_torch.frontend.features import FeaturizerConfig

    blocks = (BlockConfig(filters=16, repeat=1, kernel=9, stride=2,
                          residual=False, separable=True),
              BlockConfig(filters=16, repeat=1, kernel=7, residual=True,
                          separable=True),
              BlockConfig(filters=24, repeat=1, kernel=5, residual=True,
                          separable=True),
              BlockConfig(filters=32, repeat=1, kernel=1, residual=False))
    return ModelConfig(
        name="narrow", labels=["a", "b", "c"],
        featurizer=FeaturizerConfig(features=16, dither=0.0, normalize="",
                                    pad_to=1),
        encoder=EncoderConfig(blocks=blocks, feat_in=16),
        spec_augment=SpecAugmentConfig())


def stream_chunks(np, sig):
    """`sig` zero-padded to whole POOL_CHUNK chunks."""
    pad = np.concatenate([sig, np.zeros((-len(sig)) % POOL_CHUNK,
                                        np.float32)])
    return [pad[i:i + POOL_CHUNK] for i in range(0, len(pad), POOL_CHUNK)]


def offline_log_probs(torch, dev, cfg, folded, sig, dtype):
    """The offline forward of one signal on the card, every op in `dtype`
    (the plain featurizer's steps, then the per-op encoder)."""
    from vietasr_tpu_torch.frontend import features as F
    from vietasr_tpu_torch.models.quartznet import map_tree, quartznet_apply

    fc = cfg.featurizer
    dft = torch.from_numpy(F._windowed_dft_matrix(fc)).to(dev, dtype)
    mel = torch.from_numpy(F._mel_matrix(fc)).to(dev, dtype)
    with torch.inference_mode():
        xp = F.preemphasize_and_pad(
            torch.from_numpy(sig[None]).to(dev, dtype), fc)
        spec = xp.unfold(1, fc.fft_length, fc.hop_length) @ dft
        nb = fc.fft_length // 2 + 1
        logmel = F.log_guard((spec[..., :nb] ** 2 + spec[..., nb:] ** 2)
                             @ mel, fc)
        flens = F.feature_seq_len(torch.tensor([len(sig)], device=dev),
                                  fc.hop_length)
        feats = F.mask_and_pad_time(F._normalize(logmel, flens, fc.normalize),
                                    flens, logmel.shape[1], fc)
        lp, el = quartznet_apply(map_tree(lambda a: a.to(dtype), folded),
                                 feats, flens, cfg=cfg.encoder)
    return lp[0, :int(el[0])].double().cpu().numpy()


def wav_bytes(np, samples, sr=16000) -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())
    return buf.getvalue()


def streaming_phase(np, torch, dev, lm_paths, kernels):
    """Phase 10: the online streamer on the causal anchor in fp32, the
    StreamPool beam tier (the beam kernel on a carried state) against the
    same pool on the plain search, and AsrServer over HTTP."""
    import urllib.request

    from vietasr_tpu_torch.audio.io import read_wav
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.models.convert import load_anchor, params_from_jax
    from vietasr_tpu_torch.models.quartznet import (fold_batchnorm,
                                                    init_quartznet)
    from vietasr_tpu_torch.pipeline import Transcriber
    from vietasr_tpu_torch.serve import AsrServer
    from vietasr_tpu_torch.serve.streams import StreamPool
    from vietasr_tpu_torch.streaming_online import OnlineTranscriber

    rng = np.random.RandomState(1001)
    # a narrow model, random init, no normalization: stream == offline
    ncfg = narrow_streaming_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    nvars = fold_batchnorm(init_quartznet(gen, ncfg.encoder, ncfg.num_classes,
                                          device=dev), ncfg.encoder)
    sig = (rng.randn(3 * 16000 + 1111) * 0.1).astype(np.float32)
    got = OnlineTranscriber(ncfg, nvars, causal_norm=False).stream(
        stream_chunks(np, sig), true_samples=len(sig))
    want = offline_log_probs(torch, dev, ncfg, nvars, sig, torch.float32)
    m = min(len(got), len(want))
    err = float(np.abs(got[:m] - want[:m]).max())
    print(f"online streamer, narrow model (4 blocks, no normalization), "
          f"3 s: {m} of {len(want)} offline frames, max|d log p| {err:.3e} "
          f"(tol {STREAM_TOL})")
    check(m >= len(want) - 1 and err <= STREAM_TOL,
          f"narrow streamer vs offline: max|d log p| {err}")

    # the trained causal anchor, fp32, 20 s with a mid-chunk end
    cfg = load_config(CAUSAL_CONFIG)
    folded = fold_batchnorm(params_from_jax(load_anchor(CAUSAL_ANCHOR),
                                            device=dev), cfg.encoder)
    ot = OnlineTranscriber(cfg, folded)
    check(ot.device.type == "cuda", "OnlineTranscriber did not default to "
          "CUDA")
    n = 20 * 16000 + 1111
    sig = (rng.randn(n) * 0.1).astype(np.float32)
    chunks = stream_chunks(np, sig)
    ot.stream(chunks[:4])                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ot.stream(chunks, true_samples=n)
    dt = time.perf_counter() - t0
    want64 = offline_log_probs(torch, dev, cfg, folded, sig, torch.float64)
    want32 = offline_log_probs(torch, dev, cfg, folded, sig, torch.float32)
    m = min(len(got), len(want64))
    errs = {}
    for what, want in (("fp64", want64), ("fp32", want32)):
        errs[what] = (float(np.abs(np.exp(got[:m]) - np.exp(want[:m])).max()),
                      float(np.abs(got[:m] - want[:m]).max()))
    off32 = (float(np.abs(np.exp(want32[:m]) - np.exp(want64[:m])).max()),
             float(np.abs(want32[:m] - want64[:m]).max()))
    steps = len(chunks) + -(-ot.prefix_frames // ot.out_frames(POOL_CHUNK))
    print(f"online streamer (causal anchor, fp32), 20 s in {len(chunks)} "
          f"chunks of {POOL_CHUNK}: {m} of {len(want64)} offline frames; "
          f"(max|d p|, max|d log p|) vs the fp64 offline forward "
          f"{errs['fp64']} (bound {STREAM_ANCHOR_FACTOR:g} x the fp32 "
          f"offline forward's {off32}), vs the fp32 one {errs['fp32']}; "
          f"{dt * 1e3:.1f} ms for {steps} steps = "
          f"{dt / steps * 1e3:.2f} ms a step")
    check(m >= len(want64) - 1 and np.isfinite(got).all(),
          "streamer: frame count or finiteness")
    check(all(e <= STREAM_ANCHOR_FACTOR * o
              for e, o in zip(errs["fp64"], off32)),
          f"streamer vs the fp64 offline forward: {errs['fp64']}, the fp32 "
          f"offline forward {off32}")

    # StreamPool(slots=8, decoder="beam"): the kernel pool and the plain
    # pool in lockstep, their carried beam states compared every tick
    kw = dict(slots=8, chunk_samples=POOL_CHUNK, decoder="beam",
              lm_path=lm_paths[3], beam_width=16)
    pool_k = StreamPool(ot, **kw)
    pool_p = StreamPool(ot, beam_impl="plain", **kw)
    sched = pool_schedule(np)
    ticks = [0]

    def same_carry():
        ticks[0] += 1
        for a, b in zip(pool_k.beam_carry, pool_p.beam_carry):
            check(torch.equal(a, b), f"stream pool: the kernel's carried "
                  f"beam state differs from the plain search's at step "
                  f"{ticks[0]}")

    feeds = [0]
    feed_k = pool_k.feed

    def counted_feed(*args, **kwargs):
        feeds[0] += 1
        return feed_k(*args, **kwargs)

    pool_k.feed = counted_feed
    reset_launches()
    (pieces_k, finals_k), (pieces_p, finals_p) = drive_pools(
        [pool_k, pool_p], sched, same_carry)
    launches = read_launches()
    print(f"stream pool (8 slots, beam W=16 cutoff 8, word 3-gram, mu-law "
          f"wire), 8 streams of {[round(s[2] / 16000, 1) for s in sched]} "
          f"s: {feeds[0]} ticks, carried state equal to the plain pool's "
          f"after each, launches {launches}; final texts equal "
          f"{sum(a == b for a, b in zip(finals_k, finals_p))}/{len(sched)}, "
          f"{sum(map(len, finals_k))} characters")
    check(finals_k == finals_p and pieces_k == pieces_p,
          "stream pool texts differ from the plain pool's")
    check(launches == {"log_mel_frontend": 0, "repeat_block": 0,
                       "beam_search": feeds[0]},
          f"stream pool launches {launches} for {feeds[0]} ticks")
    add_path_launches(kernels, "stream_pool_beam", launches)

    # the kernel pool alone: ms per tick (each feed ends in the copy of
    # the slots' best hypotheses to the host)
    pool_t = StreamPool(ot, **kw)
    times = []
    feed_t = pool_t.feed

    def timed_feed(*args, **kwargs):
        t0 = time.perf_counter()
        out = feed_t(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    pool_t.feed = timed_feed
    drive_pools([pool_t], sched)
    dts = np.array(times) * 1e3
    med = float(np.median(dts))
    print(f"stream pool tick: median {med:.2f} ms, p90 "
          f"{float(np.percentile(dts, 90)):.2f} ms over {len(dts)} ticks = "
          f"{POOL_CHUNK / 16000 / (med / 1e3):.1f} audio-s/s per slot, "
          f"{8 * POOL_CHUNK / 16000 / (med / 1e3):.1f} for 8 slots")

    # the reference's web entry point, HTTP only (no websockets here)
    tr = Transcriber(CONFIG, checkpoint=ANCHOR)
    srv = AsrServer(tr, host="127.0.0.1", port=0).start(background=True)
    try:
        for seconds in (3.0, 40.0):
            data = wav_bytes(np, (rng.randn(int(seconds * 16000)) * 0.1)
                             .astype(np.float32))
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/upload", data=data,
                method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req) as r:
                out = json.load(r)
            dt = time.perf_counter() - t0
            samples, _ = read_wav(data)
            want = tr.transcribe(samples) if len(samples) <= tr.buckets[-1] \
                else tr.transcribe_long(samples)
            print(f"AsrServer /upload {seconds:g} s WAV: {dt * 1e3:.1f} ms, "
                  f"transcript equal to the Transcriber's: "
                  f"{out['transcript'] == want}")
            check(out["transcript"] == want, f"AsrServer /upload of "
                  f"{seconds} s differs from the Transcriber")
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# phase 11: the Conformer-CTC family

CONFORMER_CONFIG = os.path.join(HERE, "vietasr_tpu_torch", "configs",
                                "conformer_ctc_vi.yaml")
CONFORMER_STREAM_CONFIG = os.path.join(HERE, "vietasr_tpu_torch", "configs",
                                       "conformer_ctc_vi_streaming.yaml")
# the Conformer on the frontend kernel vs on the plain frontend, both on
# the card. The weights are a random init, whose posteriors on noise are
# nearly flat (phase 11 prints the median top-1 / top-2 margin), while
# the two routes' features differ in the last bits and a bf16 rounding
# that flips in one of 16 blocks moves the rest of the stack. So in bf16
# the routes are held to phase 5's E2E_LOGP_TOL in log p (the frame
# argmax printed), and in fp32, where the feature difference stays in
# the last bits of log p, to this frame argmax agreement
CONFORMER_ARGMAX_MIN = 0.99
# the chunked streamer vs the offline chunked forward of the same frames,
# fp32: the JAX package's streaming contract for the Conformer
CONFORMER_STREAM_TOL = 2e-4
# one attention chunk of conformer_ctc_vi_streaming: 4 x 16 frames x hop
CONFORMER_CHUNK = 10240
# a GEMM of bf16-valued fp32 operands on TF32 tensor cores vs IEEE fp32,
# relative to the largest |result|: fp32 sums of 1,024 exact products in
# another order (TF32 rounding of the operands would show as ~1e-3)
TF32_EXACT_TOL = 1e-5
# device time of a Conformer forward by group: the profiler range around a
# kernel (models/conformer.py::_range) first, then its name
CONFORMER_GROUPS = ("GEMMs", "attention elementwise + softmax",
                    "depthwise conv", "conv2d subsampling",
                    "LayerNorm / GLU / swish / residual elementwise",
                    "frontend kernel", "uploads")


def reset_conformer_counts():
    from vietasr_tpu_torch.ops.fused_ctc import fused_ctc_alpha, fused_ctc_beta

    reset_launches()
    fused_ctc_alpha.launches = 0
    fused_ctc_beta.launches = 0


def conformer_counts() -> dict:
    from vietasr_tpu_torch.ops.fused_ctc import fused_ctc_alpha, fused_ctc_beta

    return dict(read_launches(), ctc_alpha=fused_ctc_alpha.launches,
                ctc_beta=fused_ctc_beta.launches)


def n_forwards(tr, signals) -> int:
    groups = {}
    for s in signals:
        groups.setdefault(tr._bucket_len(len(s)), []).append(s)
    return sum(-(-len(g) // tr.opts.max_batch) for g in groups.values())


def conformer_device_groups(torch, fn, reps: int = 5):
    """({group: device ms per fn() call}, traced kernel ms per call): the
    kernels and copies of a trace of fn(), each attributed to the
    conformer profiler range it ran in, else by its name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(CONFORMER_GROUPS, 0.0)
    for e in prof.events():
        if not e.kernels:
            continue
        tag, p = None, e
        while p is not None:
            if p.name.startswith("conformer."):
                tag = p.name
                break
            p = p.cpu_parent
        for k in e.kernels:
            low = k.name.lower()
            if "logmel" in low:
                group = "frontend kernel"
            elif "memcpy" in low and "htod" in low:
                group = "uploads"
            elif tag == "conformer.subsample":
                group = "conv2d subsampling"
            elif tag == "conformer.depthwise":
                group = "depthwise conv"
            elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
                group = "GEMMs"
            elif tag == "conformer.mhsa":
                group = "attention elementwise + softmax"
            else:
                group = "LayerNorm / GLU / swish / residual elementwise"
            out[group] += k.duration / reps / 1e3
    return out


def tf32_exactness(torch, dev):
    """The bf16 Conformer's products run as fp32 GEMMs of bf16 values with
    TF32 tensor cores allowed (utils/device.py::exact_tensor_cores): such a
    value is exact in TF32, so the result may differ from IEEE fp32 only
    by the order of the fp32 sums. At an FFN GEMM's shape (B = 8 x T' =
    418 rows, 1024 x 256), against operands that are not bf16 values."""
    from vietasr_tpu_torch.utils.device import exact_tensor_cores, strict_fp32

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    a = torch.randn(3344, 1024, device=dev, generator=g)
    b = torch.randn(1024, 256, device=dev, generator=g)
    errs = {}
    for what, (x, y) in (("bf16 values", (a.bfloat16().float(),
                                          b.bfloat16().float())),
                         ("fp32 values", (a, b))):
        with strict_fp32():
            ref = x @ y
        with exact_tensor_cores():
            got = x @ y
        errs[what] = float((got - ref).abs().max() / ref.abs().max())
    print(f"TF32 tensor cores vs IEEE fp32 GEMM (3344 x 1024 x 256), max "
          f"|d| / max|ref|: {errs['bf16 values']:.3e} on bf16 values "
          f"(bound {TF32_EXACT_TOL:g}), {errs['fp32 values']:.3e} on fp32 "
          f"values")
    check(errs["bf16 values"] <= TF32_EXACT_TOL, "TF32 tensor cores round "
          "bf16-valued operands")


def conformer_offline_phase(np, torch, dev, signals, lm_paths, kernels):
    """Phase 11a: Transcriber on conformer_ctc_vi (full width, seeded
    init_conformer, bf16) over phase 5's signals: greedy, device beam and
    host beam, counters read around each path."""
    import torch.nn.functional as F

    from vietasr_tpu_torch.frontend.cuda_frontend import \
        log_mel_tiles_fast_cuda
    from vietasr_tpu_torch.models.conformer import num_params
    from vietasr_tpu_torch.ops.beam_search import BeamSearchDecoderLM
    from vietasr_tpu_torch.ops.device_beam import (best_path_from_raw,
                                                   device_beam_search)
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    tr = Transcriber(CONFORMER_CONFIG)     # init_conformer, seed 0, bf16
    n_par = num_params(tr._float_variables)
    check(tr.device.type == "cuda" and tr.cfg.architecture == "conformer",
          "the Conformer Transcriber is not a Conformer on CUDA")
    check(n_par == 27_346_779, f"conformer_ctc_vi has {n_par} parameters")
    plain = Transcriber(CONFORMER_CONFIG, options=TranscriberOptions(
        fused_frontend="off"))
    fp32 = Transcriber(CONFORMER_CONFIG, options=TranscriberOptions(
        compute_dtype=None))
    fp32_plain = Transcriber(CONFORMER_CONFIG, options=TranscriberOptions(
        compute_dtype=None, fused_frontend="off"))
    forwards = n_forwards(tr, signals)
    tr.transcribe_batch(signals)                       # warm-up
    reset_conformer_counts()
    texts = tr.transcribe_batch(signals)
    launches = conformer_counts()
    print(f"conformer greedy path ({n_par} parameters, bf16): "
          f"{len(signals)} signals, {forwards} forwards, launches "
          f"{launches}")
    check(launches == {"log_mel_frontend": forwards, "repeat_block": 0,
                       "beam_search": 0, "ctc_alpha": 0, "ctc_beta": 0},
          f"conformer greedy launches {launches} for {forwards} forwards")
    add_path_launches(kernels, "conformer_greedy", launches)

    pairs = {"bf16 kernel vs plain frontend": (tr, plain),
             "fp32 kernel vs plain frontend": (fp32, fp32_plain),
             "bf16 vs fp32 (kernel frontend)": (tr, fp32)}
    stats = {k: ([], 0.0) for k in pairs}
    margins = []
    for s in signals:
        out = {t: t.log_probs(s) for t in (tr, plain, fp32, fp32_plain)}
        el = out[tr][1]
        n = int(el[0])
        check(all(np.array_equal(el, e) for _, e in out.values()),
              "conformer enc_lens differ between routes")
        for lp, _ in out.values():
            check(np.isfinite(lp[0, :n]).all()
                  and np.allclose(np.exp(lp[0, :n]).sum(-1), 1.0,
                                  atol=1e-3),
                  "conformer log-probs: finiteness or normalisation")
        for k, (a, b) in pairs.items():
            la, lb = out[a][0][0, :n], out[b][0][0, :n]
            agree, worst = stats[k]
            agree.append(la.argmax(-1) == lb.argmax(-1))
            stats[k] = (agree, max(worst, float(np.abs(la - lb).max())))
        top2 = np.sort(out[fp32][0][0, :n], -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    frames = sum(map(len, stats["bf16 vs fp32 (kernel frontend)"][0]))
    same = sum(a == b for a, b in zip(texts, plain.transcribe_batch(signals)))
    margin = float(np.median(np.concatenate(margins)))
    print(f"conformer routes over {frames} frames (the fp32 forward's "
          f"median top-1 / top-2 margin {margin:.4f} in log p): " + "; ".join(
              f"{k}: frame argmax {np.mean(np.concatenate(a)):.4f}, max|d "
              f"log p| {w:.4e}" for k, (a, w) in stats.items())
          + f"; bf16 transcripts equal to the plain frontend's "
          f"{same}/{len(texts)}")
    worst_bf16 = stats["bf16 kernel vs plain frontend"][1]
    agree_fp32 = float(np.mean(np.concatenate(
        stats["fp32 kernel vs plain frontend"][0])))
    check(worst_bf16 <= E2E_LOGP_TOL, f"conformer bf16 kernel vs plain "
          f"frontend: max|d log p| {worst_bf16} > {E2E_LOGP_TOL}")
    check(agree_fp32 >= CONFORMER_ARGMAX_MIN, f"conformer fp32 kernel vs "
          f"plain frontend: frame argmax {agree_fp32}")
    path_numbers(np, torch, tr, signals, "conformer greedy path")
    del plain, fp32, fp32_plain
    tf32_exactness(torch, dev)

    # fused_frontend="fast": the bf16 frontend kernel on the same path
    fast = Transcriber(CONFORMER_CONFIG, options=TranscriberOptions(
        fused_frontend="fast"))
    fast.transcribe_batch(signals[:1])                 # warm-up
    reset_conformer_counts()
    log_mel_tiles_fast_cuda.launches = 0
    fast.transcribe_batch(signals)
    launches = dict(conformer_counts(),
                    frontend_fast=log_mel_tiles_fast_cuda.launches)
    print(f"conformer fast path: launches {launches}")
    check(launches == {"log_mel_frontend": 0, "repeat_block": 0,
                       "beam_search": 0, "ctc_alpha": 0, "ctc_beta": 0,
                       "frontend_fast": forwards},
          f"conformer fast path launches {launches}")
    add_path_launches(kernels, "conformer_fast", launches)
    del fast

    # the forward alone at B = 8 x 16.7 s, and where its device time goes
    full = signals[:8]
    batch = tr._host_batch(8, tr.buckets[-1])
    lens = np.array([len(s) for s in full], np.int32)
    for row, s in enumerate(full):
        batch[row, :len(s)] = s
    tr._fwd(batch, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        tr._fwd(batch, lens)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 20
    rows = device_profile(lambda: tr._fwd(batch, lens), reps=5)
    busy = sum(r[0] for r in rows)
    launches_per = sum(r[1] for r in rows)
    groups = conformer_device_groups(torch, lambda: tr._fwd(batch, lens))
    # the frontend kernel launches from ctypes, outside any traced op
    groups["frontend kernel"] = sum(r[0] for r in rows if "logmel" in r[2])
    full_s = sum(len(s) for s in full) / 16000
    print(f"conformer forward B=8 x 16.7 s: {dt * 1e3:.3f} ms = "
          f"{full_s / dt:.1f} audio-s/s; device busy {busy:.4f} ms "
          f"({100 * (1 - busy / (dt * 1e3)):.1f} % idle), {launches_per:g} "
          f"device ops a forward; by group (ms): "
          + ", ".join(f"{g} {ms:.4f}" for g, ms in groups.items())
          + f" (sum {sum(groups.values()):.4f})")
    for ms, count, key in rows[:10]:
        print(f"  {ms:8.4f} ms  x{count:<4g} {key[:100]}")

    # device beam, W = 100, the word 3-gram: one launch per call
    trb = Transcriber(CONFORMER_CONFIG, options=TranscriberOptions(
        decoder="device_beam", lm_path=lm_paths[3]))
    check(trb._device_word_lm is not None, "the word LM was not sniffed")
    labels = trb.cfg.labels
    trb.transcribe_batch(signals)                      # warm-up
    batches = forward_batches(np, torch, trb, signals)
    reset_conformer_counts()
    btexts = trb.transcribe_batch(signals)
    launches = conformer_counts()
    print(f"conformer device beam path (W={trb.opts.beam_width}, word "
          f"3-gram): launches {launches}")
    check(launches == {"log_mel_frontend": forwards, "repeat_block": 0,
                       "beam_search": 1, "ctc_alpha": 0, "ctc_beta": 0},
          f"conformer device beam launches {launches}")
    add_path_launches(kernels, "conformer_device_beam", launches)
    t_max = max(lp.shape[1] for _, lp, _ in batches)
    lp = torch.cat([F.pad(lp, (0, 0, 0, t_max - lp.shape[1]))
                    for _, lp, _ in batches])
    el = torch.cat([e for _, _, e in batches])
    order = [g for group, _, _ in batches for g in group]
    kw = dict(beam_width=trb.opts.beam_width, space=labels.index(" "),
              word_lm=trb._device_word_lm, wlm_probes=trb._device_wlm_probes,
              **BEAM_KW)
    raw_k = fused_beam_search(lp, el, blank=len(labels), return_raw=True,
                              **kw)
    raw_p = device_beam_search(lp, el, blank=len(labels), return_raw=True,
                               **kw)
    torch.cuda.synchronize()
    raw_equal = all(torch.equal(a, b) for a, b in zip(raw_k, raw_p))
    ids, n = best_path_from_raw(*raw_p, word_lm=kw["word_lm"],
                                alpha=BEAM_KW["alpha"], beta=BEAM_KW["beta"],
                                wlm_probes=kw["wlm_probes"])
    plain_texts = [None] * len(signals)
    for g, text in zip(order, render(labels, ids, n)):
        plain_texts[g] = text
    same = sum(a == b for a, b in zip(btexts, plain_texts))
    print(f"conformer device beam: B={lp.shape[0]} T={t_max} raw state / "
          f"backpointers equal to the plain search {raw_equal}; transcripts "
          f"equal {same}/{len(btexts)}")
    check(raw_equal, "conformer device beam: the kernel's raw result "
          "differs from the plain search")
    check(same == len(btexts), "conformer device beam transcripts differ "
          "from the plain search's")
    path_numbers(np, torch, trb, signals, "conformer device beam path")
    del trb

    # host beam from the PROBING binary on the 4 shortest signals
    four = sorted(signals, key=len)[:4]
    trh = Transcriber(CONFORMER_CONFIG, options=TranscriberOptions(
        decoder="beam", lm_path=lm_paths["probing"]))
    check(trh._decoder is not None and trh._decoder._native is not None,
          "the host beam decoder did not take the C++ tier")
    reset_conformer_counts()
    t0 = time.perf_counter()
    htexts = trh.transcribe_batch(four)
    dt = time.perf_counter() - t0
    launches = conformer_counts()
    # the C++ tier on the same log-probs (the call's own forwards: another
    # batch would round bf16 otherwise), over the same binary and the ARPA
    same = {}
    for kind in ("probing", 3):
        ref = BeamSearchDecoderLM(labels, lm_path=lm_paths[kind],
                                  alpha=BEAM_KW["alpha"],
                                  beta=BEAM_KW["beta"],
                                  beam_width=trh.opts.beam_width)
        check(ref._native is not None, "the reference decoder is not C++")
        want = [None] * len(four)
        for group, lp, el in forward_batches(np, torch, trh, four):
            texts_k = ref.decode_batch(lp.float().cpu().numpy(),
                                       el.cpu().numpy())
            for g, text in zip(group, texts_k):
                want[g] = text
        same[kind] = sum(a == b for a, b in zip(htexts, want))
    print(f"conformer host beam (W={trh.opts.beam_width}, PROBING): 4 "
          f"signals in {dt * 1e3:.1f} ms, launches {launches}; transcripts "
          f"equal to the C++ tier on the same log-probs over the PROBING "
          f"binary {same['probing']}/4, over the ARPA {same[3]}/4")
    check(launches["beam_search"] == 0 and launches["repeat_block"] == 0
          and launches["log_mel_frontend"] == n_forwards(trh, four),
          f"conformer host beam launches {launches}")
    check(same["probing"] == 4 and same[3] == 4,
          "conformer host beam transcripts differ")
    del trh


def conformer_streaming_phase(np, torch, dev, lm_paths, kernels):
    """Phase 11b: the chunked streamer on conformer_ctc_vi_streaming
    (full width, fp32, seeded init_conformer) against the offline chunked
    forward of the frames it saw, and two Conformer StreamPools in
    lockstep, the beam kernel's carried state against the plain search."""
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.models import model_init
    from vietasr_tpu_torch.models.conformer import (conformer_apply,
                                                    num_params)
    from vietasr_tpu_torch.serve.streams import StreamPool
    from vietasr_tpu_torch.streaming_conformer import \
        ConformerOnlineTranscriber
    from vietasr_tpu_torch.streaming_online import StreamingFeaturizer

    cfg = load_config(CONFORMER_STREAM_CONFIG)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    variables = model_init(gen, cfg, device=dev)
    n_par = num_params(variables)
    check(n_par == 25_525_339, f"conformer_ctc_vi_streaming has {n_par} "
          "parameters")
    ot = ConformerOnlineTranscriber(cfg, variables, causal_norm=False)
    check(ot.device.type == "cuda" and ot.skip_first_step
          and ot.required_chunk_samples == CONFORMER_CHUNK,
          "conformer streamer: device, skip_first_step or chunk")
    rng = np.random.RandomState(1101)
    cs = CONFORMER_CHUNK
    n_chunks = 32                                       # 20.48 s
    sig = (rng.randn(n_chunks * cs) * 0.1).astype(np.float32)
    chunks = [sig[i * cs:(i + 1) * cs] for i in range(n_chunks)]
    ot.stream(chunks[:3])                               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ot.stream(chunks)
    dt = time.perf_counter() - t0
    sf = StreamingFeaturizer(cfg.featurizer, causal_norm=False,
                             junk_align=ot._sf.junk_frames, device=dev)
    fields = sf.init_fields(1)
    first = torch.from_numpy(chunks[0]).to(dev)[None]
    fields = (sf.reflect_carry(first),) + fields[1:]
    frames = []
    with torch.inference_mode():
        for c in chunks:
            fields, out = sf.step(fields, torch.from_numpy(c).to(dev)[None])
            frames.append(out[0])
        window = torch.cat(frames, 0)[ot._sf.junk_frames:]
        want, _ = conformer_apply(variables, window[None],
                                  torch.tensor([window.shape[0]], device=dev),
                                  cfg=cfg.conformer)
    want = want[0].cpu().numpy()
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    print(f"conformer streamer (conformer_ctc_vi_streaming, {n_par} "
          f"parameters, fp32, chunk 16 left 4), {n_chunks * cs / 16000:.2f} s "
          f"in {n_chunks} chunks of {cs}: {got.shape[0]} frames, max|d log "
          f"p| vs the offline chunked forward {err:.3e} (tol "
          f"{CONFORMER_STREAM_TOL}); {dt / n_chunks * 1e3:.2f} ms a step")
    check(err <= CONFORMER_STREAM_TOL, f"conformer streamer vs offline: "
          f"{err}")

    # StreamPool(slots=8, decoder="beam") on the beam kernel and on the
    # plain search in lockstep, their carried states compared every tick
    ot = ConformerOnlineTranscriber(cfg, variables)     # causal stats
    kw = dict(slots=8, decoder="beam", lm_path=lm_paths[3], beam_width=16)
    pool_k = StreamPool(ot, **kw)
    pool_p = StreamPool(ot, beam_impl="plain", **kw)
    check(pool_k.chunk_samples == cs, f"conformer pool chunk "
          f"{pool_k.chunk_samples}")
    check(pool_k._dsb.skip_frames == ot.prefix_frames == 16,
          "conformer pool: the device beam does not skip one chunk")
    sched = pool_schedule(np, cs)
    ticks, feeds = [0], [0]

    def same_carry():
        ticks[0] += 1
        for a, b in zip(pool_k.beam_carry, pool_p.beam_carry):
            check(torch.equal(a, b), f"conformer pool: the kernel's carried "
                  f"beam state differs from the plain search's at step "
                  f"{ticks[0]}")

    feed_k = pool_k.feed

    def counted_feed(*args, **kwargs):
        feeds[0] += 1
        return feed_k(*args, **kwargs)

    pool_k.feed = counted_feed
    reset_conformer_counts()
    (pieces_k, finals_k), (pieces_p, finals_p) = drive_pools(
        [pool_k, pool_p], sched, same_carry, chunk=cs)
    launches = conformer_counts()
    print(f"conformer stream pool (8 slots, beam W=16 cutoff 8, word "
          f"3-gram, mu-law wire, chunk {cs}), 8 streams of "
          f"{[round(s[2] / 16000, 1) for s in sched]} s: {feeds[0]} ticks, "
          f"carried state equal to the plain pool's after each, launches "
          f"{launches}; final texts equal "
          f"{sum(a == b for a, b in zip(finals_k, finals_p))}/{len(sched)}, "
          f"{sum(map(len, finals_k))} characters")
    check(finals_k == finals_p and pieces_k == pieces_p,
          "conformer pool texts differ from the plain pool's")
    check(launches == {"log_mel_frontend": 0, "repeat_block": 0,
                       "beam_search": feeds[0], "ctc_alpha": 0,
                       "ctc_beta": 0},
          f"conformer pool launches {launches} for {feeds[0]} ticks")
    add_path_launches(kernels, "conformer_stream_pool_beam", launches)

    pool_t = StreamPool(ot, **kw)
    times = []
    feed_t = pool_t.feed

    def timed_feed(*args, **kwargs):
        t0 = time.perf_counter()
        out = feed_t(*args, **kwargs)
        times.append(time.perf_counter() - t0)
        return out

    pool_t.feed = timed_feed
    drive_pools([pool_t], sched, chunk=cs)
    dts = np.array(times) * 1e3
    med = float(np.median(dts))
    print(f"conformer stream pool tick: median {med:.2f} ms, p90 "
          f"{float(np.percentile(dts, 90)):.2f} ms over {len(dts)} ticks = "
          f"{cs / 16000 / (med / 1e3):.1f} audio-s/s per slot, "
          f"{8 * cs / 16000 / (med / 1e3):.1f} for 8 slots")


KERNEL_GROUPS = {
    "ctc alpha kernel": ("alpha_kernel",),
    "ctc beta kernel": ("beta_kernel",),
    "frontend kernel": ("logmel_kernel",),
    "cuBLAS GEMMs": ("gemm", "xmma", "cutlass"),
    "cuDNN": ("cudnn",),
    "depthwise conv (aten)": ("conv_depthwise",),
    "host-to-device copies": ("memcpy htod",),
}


def device_time_by_group(rows, groups=None) -> dict:
    """{group: device ms} of device_profile rows, by kernel name (the first
    group with a word in it); the rest (elementwise, reductions, copies on
    the card) as "other"."""
    groups = groups or KERNEL_GROUPS
    out = {g: 0.0 for g in groups}
    out["other"] = 0.0
    for ms, _, key in rows:
        low = key.lower()
        group = next((g for g, words in groups.items()
                      if any(w in low for w in words)), "other")
        out[group] += ms
    return out


def train_batch(np, cfg):
    """B = 32 seeded signals of 1.5-16.7 s (x 0.1) padded to the 16.7 s
    bucket, each with a VI_CORPUS transcript of ~13 characters per second."""
    from vietasr_tpu_torch.audio import Batch, CharTokenizer

    sr = cfg.featurizer.sample_rate
    bsz, n = TRAIN_BATCH, int(16.7 * sr)
    rng = np.random.RandomState(77)
    secs = rng.uniform(1.5, 16.7, size=bsz)
    secs[0] = 16.7
    tok = CharTokenizer(cfg.labels)
    text = " ".join(VI_CORPUS)
    signal = np.zeros((bsz, n), np.float32)
    lens = np.minimum((secs * sr).astype(np.int32), n)
    ids = []
    for i in range(bsz):
        signal[i, :lens[i]] = rng.randn(lens[i]) * 0.1
        k = int(round(13 * secs[i]))
        off = rng.randint(0, len(text) - k)
        ids.append(tok.encode(text[off:off + k]))
    tokens = np.zeros((bsz, max(map(len, ids))), np.int32)
    for i, t in enumerate(ids):
        tokens[i, :len(t)] = t
    return Batch(signal, lens, tokens,
                 np.array([len(t) for t in ids], np.int32))


def train_phase(np, torch, dev, kernels):
    """Phase 8: Trainer.fit on QuartzNet12x1_vi at full width in bf16."""
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.models.quartznet import init_quartznet, tree_leaves
    from vietasr_tpu_torch.ops import fused_ctc as fc
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block
    from vietasr_tpu_torch.train import (Trainer, TrainState, make_optimizer,
                                         make_schedule)
    from vietasr_tpu_torch.train.loop import batch_to_tensors, make_loss_fn
    from vietasr_tpu_torch.train.optim import global_norm

    cfg = load_config(CONFIG)
    batch = train_batch(np, cfg)
    audio_s = float(batch.signal_lens.sum()) / cfg.featurizer.sample_rate
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    variables = init_quartznet(gen, cfg.encoder, cfg.num_classes, device=dev)
    n_params = sum(int(p.numel()) for p in tree_leaves(variables["params"]))
    schedule = make_schedule("CosineAnnealing", 0.02, TRAIN_STEPS,
                             warmup_steps=TRAIN_WARMUP)
    opt = make_optimizer("novograd", schedule, weight_decay=0.001)

    def trainer(compute_dtype="bfloat16", **kw):
        return Trainer(cfg, compute_dtype=compute_dtype,
                       lr_schedule=schedule, seed=0, **kw)

    print(f"train: QuartzNet12x1_vi {n_params} params, B={len(batch.signal_lens)}"
          f" x 16.7 s bucket ({audio_s:.1f} audio-s), labels up to "
          f"{batch.tokens.shape[1]}")

    # 3 steps through the kernels, again, and through the plain CTC (the
    # scan that autograd differentiates), from the same state and seed,
    # cuDNN held to deterministic algorithms so that the CTC route is the
    # only difference
    torch.backends.cudnn.deterministic = True
    for dtype, (tol_gn, tol_loss, tol_param) in TRAIN_ROUTE_TOLS.items():
        runs = {}
        for key, impl in (("kernel", "auto"), ("again", "auto"),
                          ("plain", "plain")):
            st = TrainState.create(variables, opt)
            tr = trainer(dtype, log_every=1, ctc_impl=impl)
            tr.fit(st, [batch] * 3)
            runs[key] = ([(h["loss"], h["grad_norm"]) for h in tr.history
                          if "loss" in h], st.param_list())
        (k_hist, k_params), (p_hist, p_params) = runs["kernel"], runs["plain"]
        check(bool(np.isfinite(k_hist).all()), f"train: non-finite {k_hist}")
        same = k_hist == runs["again"][0] and all(
            torch.equal(a, b) for a, b in zip(k_params, runs["again"][1]))
        rel = [[abs(a - b) / abs(b) for a, b in zip(k, p)]
               for k, p in zip(k_hist, p_hist)]
        with torch.no_grad():
            moved = global_norm([a - b for a, b in zip(
                k_params, tree_leaves(variables["params"]))])
            d_param = float(global_norm([a - b for a, b in zip(
                k_params, p_params)]) / moved)
        print(f"train 3 steps {dtype or 'float32'}, kernel CTC vs plain CTC: "
              f"(loss, grad norm) {k_hist} vs {p_hist}; relative differences "
              f"{rel}; |params_k - params_plain| / |params_k - params_0| "
              f"{d_param:.3e}; kernel run repeated bit for bit: {same}")
        check(same, "train: the kernel route does not repeat bit for bit")
        check(rel[0][0] <= CTC_TOL and rel[0][1] <= tol_gn,
              f"train: step 1 (loss, grad norm) differ by {rel[0]}")
        check(max(r[0] for r in rel) <= tol_loss,
              f"train: kernel vs plain losses differ by {rel}")
        check(d_param <= tol_param,
              f"train: kernel vs plain params differ by {d_param} of the move")
    torch.backends.cudnn.deterministic = False

    # the main path: one warm-up step, then 10 timed steps
    state = TrainState.create(variables, opt)
    tr = trainer(log_every=1)
    tr.fit(state, [batch])
    first = tr.history[0]["loss"]
    tr.log_every = 10
    torch.cuda.synchronize()
    for f in (fc.fused_ctc_alpha, fc.fused_ctc_beta, fused_log_mel_features,
              fused_repeat_block):
        f.launches = 0
    t0 = time.perf_counter()
    tr.fit(state, [batch] * 10)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 10
    launches = {"ctc_alpha": fc.fused_ctc_alpha.launches,
                "ctc_beta": fc.fused_ctc_beta.launches,
                "log_mel_frontend": fused_log_mel_features.launches,
                "repeat_block": fused_repeat_block.launches}
    print(f"train main path: 10 steps, launches {launches}")
    check(launches == {"ctc_alpha": 10, "ctc_beta": 10,
                       "log_mel_frontend": 10, "repeat_block": 0},
          f"train: launches {launches} for 10 steps")
    for k in kernels:
        if k["name"] in ("ctc_alpha", "ctc_beta"):
            k["launches"] = launches[k["name"]]
    PHASE8["step_ms"] = dt * 1e3
    print(f"train step B={len(batch.signal_lens)} x 16.7 s bucket: "
          f"{dt * 1e3:.2f} ms = "
          f"{audio_s / dt:.1f} trained audio-s/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    rows = device_profile(lambda: tr.fit(state, [batch]), reps=3)
    busy = sum(r[0] for r in rows)
    print(f"profile of one train step: device busy {busy:.4f} ms of "
          f"{dt * 1e3:.4f} ms wall ({100 * (1 - busy / (dt * 1e3)):.1f} % "
          f"idle)")
    # the forward alone (training mode, no autograd) on the same batch: the
    # step less the forward is the backward and the update
    loss_fn = make_loss_fn(cfg, compute_dtype=torch.bfloat16, device=dev)
    tensors = batch_to_tensors(batch, dev)

    @torch.no_grad()
    def forward():
        loss_fn(state.params, state.batch_stats, tensors, gen, True)

    fwd = device_time_by_group(device_profile(forward, reps=3))
    step = device_time_by_group(rows)
    print("  device ms per step (forward / backward + update):")
    for g in step:
        print(f"    {g:<28} {step[g]:8.4f} ({fwd[g]:.4f} / "
              f"{step[g] - fwd[g]:.4f})")
    for ms, count, key in rows[:15]:
        print(f"  {ms:8.4f} ms  x{count:<5g} {key[:100]}")

    # on to step 30 on the same batch
    tr.fit(state, [batch] * (TRAIN_STEPS - int(state.step)))
    logged = [(h["step"], h["loss"]) for h in tr.history if "loss" in h]
    last = logged[-1][1]
    skipped = int(state.skipped_steps)
    print(f"train {int(state.step)} steps on one batch: loss {first:.3f} -> "
          f"{last:.3f} ({last / first:.3f}x; logged {logged}), skipped "
          f"{skipped}")
    check(int(state.step) == TRAIN_STEPS and logged[-1][0] == TRAIN_STEPS,
          "train: step count")
    check(skipped == 0, f"train: {skipped} steps skipped (non-finite)")
    check(all(np.isfinite([l for _, l in logged])), "train: non-finite loss")
    check(last < 0.7 * first, f"train: loss {first} -> {last}, not < 0.7x")


# ---------------------------------------------------------------------------
# phase 12: training from a manifest through the command line, Jasper10x5dr,
# Conformer training


# Jasper10x5dr at its published widths (Li et al. 2019, "Jasper", Table 1;
# NeMo's jasper10x5dr.yaml): a k11 s2 prologue, B1-B5 x 2 blocks of 5
# repeats with dense residuals, a dilated k29 epilogue and a k1 1024 block
JASPER_PAPER_PARAMS = 333e6
# phase 12d: remat vs no remat gradients (fp32, dropout 0, cuDNN held to
# deterministic algorithms): the same ops recomputed; relative to each
# leaf's largest gradient
REMAT_GRAD_RTOL = 1e-5
# phase 12a's training corpus: 64 clips in two of the 8 default duration
# buckets (14.6-16.7 s and 6.3-8.35 s), 32 in each, so that every batch of
# B = 32 is full and comes from the batcher's full-batch branch
CLI_TRAIN_SPANS = ((14.7, 16.7), (6.3, 8.3))
CLI_TRAIN_EPOCHS = 4
# phase 12c's groups: cuDNN's convolution kernels first ("implicit_convolve_
# sgemm" holds "gemm" too), then the GEMMs of the 1x1s and the head
JASPER_GROUPS = {"cuDNN convolutions": ("convolve", "fprop", "cudnn"),
                 "GEMMs (1x1s, head)": ("gemm", "xmma", "cutlass")}


def jasper10x5dr_blocks():
    from vietasr_tpu_torch.config import BlockConfig

    blocks = [BlockConfig(filters=256, kernel=11, stride=2, dropout=0.2,
                          residual=False)]
    for filters, kernel, drop in ((256, 11, 0.2), (384, 13, 0.2),
                                  (512, 17, 0.2), (640, 21, 0.3),
                                  (768, 25, 0.3)):
        blocks += [BlockConfig(filters=filters, repeat=5, kernel=kernel,
                               dropout=drop, residual=True,
                               residual_dense=True)] * 2
    return blocks + [BlockConfig(filters=896, kernel=29, dilation=2,
                                 dropout=0.4, residual=False),
                     BlockConfig(filters=1024, kernel=1, dropout=0.4,
                                 residual=False)]


def jasper_flops(ecfg, t_in: int, bsz: int) -> float:
    """Multiply-adds x 2 of every convolution of a (dense, unseparable)
    Jasper encoder over bsz rows of t_in feature frames (the head left
    out)."""
    from vietasr_tpu_torch.models.layers import conv_out_length

    total, t, c_in, dense = 0.0, t_in, ecfg.feat_in, []
    for b in ecfg.blocks:
        t_out = int(conv_out_length(t, b.effective_kernel, b.stride,
                                    b.dilation, b.same_padding))
        c = c_in
        for _ in range(b.repeat):
            total += 2.0 * b.effective_kernel * c * b.filters * t_out
            c = b.filters
        if b.residual_dense:
            dense.append(c_in)
            panes = list(dense)
        else:
            panes = [c_in] if b.residual else []
        total += sum(2.0 * p * b.filters * t_out for p in panes)
        t, c_in = t_out, b.filters
    return bsz * total


def write_corpus(np, folder, name, n, seed, spans=((1.5, 16.7),)):
    """n seeded 16 kHz PCM16 WAVs (noise x 0.1), clip i's duration drawn
    from spans[i % len(spans)] (clip 0 is 16.7 s), with VI_CORPUS
    transcripts of ~13 characters a second, and their manifest. Returns
    (manifest path, [(wav path, samples)])."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    text = " ".join(VI_CORPUS)
    lines, clips = [], []
    for i in range(n):
        secs = 16.7 if i == 0 else float(rng.uniform(*spans[i % len(spans)]))
        pcm = (rng.randn(int(secs * 16000)) * 0.1 * 32767).clip(
            -32768, 32767).astype(np.int16)
        path = os.path.join(folder, f"{name}{i:03d}.wav")
        wavfile.write(path, 16000, pcm)
        k = int(round(13 * secs))
        off = rng.randint(0, len(text) - k)
        lines.append({"audio_filepath": path, "duration": len(pcm) / 16000,
                      "text": text[off:off + k].strip()})
        clips.append((path, pcm.astype(np.float32) / 32768.0))
    manifest = os.path.join(folder, f"{name}.json")
    with open(manifest, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(json.dumps(line, ensure_ascii=False) + "\n")
    return manifest, clips


def run_cli(argv):
    """cli.main(argv) in this process: (exit code, stdout, wall s)."""
    import contextlib
    import io

    from vietasr_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def json_lines(out: str) -> list:
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def path_kernel_check(torch, dev, cfg, variables, batch, what, dtype):
    """The kernels of a phase 12 path against their plain versions at that
    path's own shapes: the fp32 frontend on `batch`'s signals (padded rows
    included, dither 0) at phase 3's tolerance, then the CTC pair on the
    log-probs and targets that the loss gives this batch (eval mode,
    `dtype`) through ctc_compare, phase 7's check. Raises on a
    difference."""
    import dataclasses

    from vietasr_tpu_torch.frontend.cuda_frontend import (
        fft_tables, fused_log_mel_features)
    from vietasr_tpu_torch.train.loop import batch_to_tensors, make_loss_fn

    fcfg = dataclasses.replace(cfg.featurizer, dither=0.0)
    t = batch_to_tensors(batch, dev)
    sig, lens = t["signal"], t["signal_lens"]
    got, got_len = fused_log_mel_features(sig, lens, cfg=fcfg,
                                          tables=fft_tables(fcfg, dev))
    f_err = hold_frontend(torch, fcfg, sig, lens, got, got_len, what)

    loss_fn = make_loss_fn(cfg, use_specaug=False, compute_dtype=dtype,
                           device=dev)
    with torch.no_grad():
        _, (_, lp, enc_lens) = loss_fn(variables["params"],
                                       variables["batch_stats"], t, None,
                                       False)
    c = ctc_lattice(lp.float().contiguous(), t["tokens"], enc_lens,
                    t["token_lens"], cfg.num_classes)
    d_ll, d_a, d_g, _, differ = ctc_compare(torch, c)
    print(f"{what}: kernels vs plain at the path's shapes: frontend "
          f"B = {sig.shape[0]} x {sig.shape[1]} samples ({int((lens == 0).sum())}"
          f" rows of length 0) -> {tuple(got.shape)}, max|d| {f_err:.3e} "
          f"(tol {FRONTEND_TOL}); CTC pair on the loss's log-probs "
          f"{tuple(lp.shape)}, S = {c['lp_ext'].shape[2]}, input lengths "
          f"{int(enc_lens.min())}-{int(enc_lens.max())}: |d ll| {d_ll:.3e}, "
          f"relative |d alpha| {d_a:.3e}, |d grad| {d_g:.3e} (tol "
          f"{CTC_TOL}), elements differing {differ}")


def cli_phase(np, torch, dev, kernels, tmp):
    """Phase 12a-b: `train` from a 64-clip manifest, resumed, then `eval`
    and `transcribe` from its checkpoint, each against the library call it
    wraps; the kernels against their plain versions on the largest batch
    of each of train's and eval's batchers."""
    from vietasr_tpu_torch.audio import (AudioTextDataset, BucketBatcher,
                                         CharTokenizer, read_manifest)
    from vietasr_tpu_torch.cli import train_batcher
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions
    from vietasr_tpu_torch.train import (CheckpointManager, TrainState,
                                         Trainer, make_optimizer)

    cfg = load_config(CONFIG)
    train_m, _ = write_corpus(np, tmp, "train", 64, seed=12,
                              spans=CLI_TRAIN_SPANS)
    eval_m, eval_clips = write_corpus(np, tmp, "eval", 16, seed=13)
    work = os.path.join(tmp, "work")
    argv = ["--device", dev.type, "train", "--config", CONFIG,
            "--train-manifest", train_m, "--work-dir", work,
            "--batch-size", "32", "--optimizer", "novograd",
            "--augment", "speed,gain,noise,shift", "--warmup-steps", "2",
            "--num-epochs", str(CLI_TRAIN_EPOCHS),
            "--compute-dtype", "bfloat16",
            "--log-every", "1", "--checkpoint-every", "1000"]
    audio_s = CLI_TRAIN_EPOCHS * sum(e.duration for e in read_manifest(
        train_m, min_duration=cfg.data.min_duration,
        max_duration=cfg.data.max_duration))

    reset_conformer_counts()
    rc, out, wall = run_cli(argv)
    counts = conformer_counts()
    steps = [m for m in json_lines(out) if "loss" in m]
    n = len(steps)
    payload = torch.load(os.path.join(work, f"state-STEP-{n}.pt"),
                         map_location="cpu", weights_only=True)
    step_s = sum(m["step_time"] for m in steps)
    print(f"cli train: rc {rc}, {n} steps of B = 32 ({CLI_TRAIN_EPOCHS} "
          f"epochs of 64 clips in 2 full buckets, {audio_s:.1f} audio-s), "
          f"losses "
          f"{[round(m['loss'], 3) for m in steps]}; launches {counts}; "
          f"skipped {payload['skipped_steps']}; call wall {wall:.2f} s, "
          f"steps {step_s * 1e3:.2f} ms in all = "
          f"{step_s / max(n, 1) * 1e3:.2f} ms a step, "
          f"{audio_s / step_s:.1f} trained audio-s/s over the steps, "
          f"{audio_s / wall:.1f} over the call")
    check(rc == 0 and 6 <= n <= 10, f"cli train: rc {rc}, {n} steps")
    check(counts == {"log_mel_frontend": n, "repeat_block": 0,
                     "beam_search": 0, "ctc_alpha": n, "ctc_beta": n},
          f"cli train: launches {counts} for {n} steps")
    check(payload["step"] == n and payload["skipped_steps"] == 0,
          f"cli train: checkpoint step {payload['step']}, skipped "
          f"{payload['skipped_steps']}")
    check(all(np.isfinite(m["loss"]) for m in steps), "cli train: loss")
    add_path_launches(kernels, "cli_train", counts)

    # the resumed call, under the profiler: the step's device busy time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc2, out2, wall2 = run_cli(argv)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")) / 1e3
    steps2 = [m for m in json_lines(out2) if "loss" in m]
    step2_ms = sum(m["step_time"] for m in steps2) * 1e3
    print(f"cli train resumed: rc {rc2}, '{out2.splitlines()[0]}', "
          f"{len(steps2)} more steps, {step2_ms:.2f} ms of steps (traced), "
          f"device busy {busy:.2f} ms over the call = "
          f"{busy / max(len(steps2), 1):.2f} ms a step; idle "
          f"{100 * (1 - busy / step2_ms):.1f} % of the steps' wall")
    check(rc2 == 0 and f"resumed from step {n}" in out2
          and f"done at step {2 * n}" in out2, "cli train: resume")
    # a third call, untraced: every bucket's shape has been seen before
    rc3, out3, wall3 = run_cli(argv)
    steps3 = [m for m in json_lines(out3) if "loss" in m]
    step3_s = sum(m["step_time"] for m in steps3)
    print(f"cli train, third call: rc {rc3}, {len(steps3)} steps, "
          f"{step3_s / max(len(steps3), 1) * 1e3:.2f} ms a step = "
          f"{audio_s / step3_s:.1f} trained audio-s/s over the steps, "
          f"{audio_s / wall3:.1f} over the call ({wall3:.2f} s); idle vs "
          f"the traced call's busy "
          f"{100 * (1 - busy / (step3_s * 1e3)):.1f} %")
    check(rc3 == 0 and len(steps3) == n, "cli train: third call")

    # the host side alone: one epoch over the CLI's own augmenting batcher
    batcher = train_batcher(cfg, train_m, 32,
                            augment="speed,gain,noise,shift", seed=0)
    t0 = time.perf_counter()
    batches = list(batcher)
    dt = time.perf_counter() - t0
    epoch_s = audio_s / CLI_TRAIN_EPOCHS
    print(f"BucketBatcher alone (read + augment + pad, one host thread): "
          f"{len(batches)} batches ({[int((b.signal_lens > 0).sum()) for b in batches]}"
          f" real rows) in {dt:.3f} s = {len(batches) / dt:.2f} batches/s, "
          f"{epoch_s / dt:.1f} audio-s/s")
    variables = CheckpointManager(work, device=dev).restore_variables()
    path_kernel_check(torch, dev, cfg, variables,
                      max(batches, key=lambda b: b.signal.shape[1]),
                      "cli train, largest bucket", torch.bfloat16)

    # eval: the CLI's JSON == Trainer.evaluate on the restored variables
    torch.backends.cudnn.deterministic = True
    reset_conformer_counts()
    rc, out, wall = run_cli(["--device", dev.type, "eval", "--config", CONFIG,
                             "--checkpoint-dir", work, "--manifest", eval_m,
                             "--batch-size", "16"])
    counts = conformer_counts()
    got = json_lines(out)[-1]
    variables = CheckpointManager(work, device=dev).restore_variables()
    eval_batcher = BucketBatcher(AudioTextDataset(
        read_manifest(eval_m), CharTokenizer(cfg.labels)), 16, shuffle=False)
    want = Trainer(cfg, device=dev).evaluate(
        TrainState.create(variables, make_optimizer("sgd", 0.0)),
        eval_batcher)
    torch.backends.cudnn.deterministic = False
    print(f"cli eval: {got} in {wall:.2f} s; Trainer.evaluate {want}; "
          f"launches {counts}")
    check(rc == 0 and got == want, "cli eval differs from Trainer.evaluate")
    add_path_launches(kernels, "cli_eval", counts)
    path_kernel_check(torch, dev, cfg, variables,
                      max(eval_batcher, key=lambda b: b.signal.shape[1]),
                      "cli eval, largest bucket", None)

    # transcribe, greedy and device beam: the CLI's texts == Transcriber's
    wavs = [p for p, _ in eval_clips]
    for decoder in ("greedy", "device_beam"):
        tr = Transcriber(CONFIG, variables=variables, device=dev,
                         options=TranscriberOptions(decoder=decoder))
        want = tr.transcribe_batch([x for _, x in eval_clips])
        reset_conformer_counts()
        rc, out, wall = run_cli(["--device", dev.type, "transcribe",
                                 "--config", CONFIG, "--checkpoint-dir",
                                 work, "--decoder", decoder, *wavs])
        counts = conformer_counts()
        got = [l["pred_text"] for l in json_lines(out)]
        fwd = n_forwards(tr, [x for _, x in eval_clips])
        print(f"cli transcribe ({decoder}): {len(got)} texts in "
              f"{wall:.2f} s, {sum(t == w for t, w in zip(got, want))}/"
              f"{len(want)} equal to Transcriber's; {fwd} forwards, launches {counts}")
        check(rc == 0 and got == want,
              f"cli transcribe ({decoder}) differs from the Transcriber")
        check(counts["log_mel_frontend"] == fwd
              and counts["repeat_block"] == 13 * fwd
              and counts["beam_search"] == (decoder == "device_beam")
              and counts["ctc_alpha"] == 0,
              f"cli transcribe ({decoder}): launches {counts}")
        add_path_launches(kernels, "cli_transcribe" if decoder == "greedy"
                          else "cli_transcribe_device_beam", counts)


def jasper_phase(np, torch, dev, kernels):
    """Phase 12c: Jasper10x5dr at full width, built in code."""
    import dataclasses

    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.models.quartznet import (cast_matmul_weights,
                                                    fold_batchnorm,
                                                    init_quartznet,
                                                    quartznet_apply,
                                                    tree_leaves)
    from vietasr_tpu_torch.train import (TrainState, Trainer,
                                         make_optimizer)
    from vietasr_tpu_torch.train.loop import make_train_featurizer

    base = load_config(CONFIG)
    cfg = dataclasses.replace(base, name="jasper10x5dr", encoder=
                              dataclasses.replace(
                                  base.encoder,
                                  blocks=tuple(jasper10x5dr_blocks())))
    variables = init_quartznet(torch.Generator(device=dev).manual_seed(0),
                               cfg.encoder, cfg.num_classes, device=dev)
    n_params = sum(int(p.numel()) for p in tree_leaves(variables["params"]))
    batch = train_batch(np, cfg)
    sig = torch.from_numpy(batch.signal[:8]).to(dev)
    lens = torch.from_numpy(batch.signal_lens[:8]).to(dev)
    featurize = make_train_featurizer(cfg, dev)
    with torch.no_grad():
        feats, flens = featurize(sig, lens, generator=None, training=False)
    folded = fold_batchnorm(variables, cfg.encoder)
    bf16 = cast_matmul_weights(folded, torch.bfloat16)

    def forward(v, dtype):
        with torch.no_grad():
            return quartznet_apply(v, feats, flens, cfg=cfg.encoder,
                                   compute_dtype=dtype)

    reset_conformer_counts()
    lp16, out_lens = forward(bf16, torch.bfloat16)
    counts = conformer_counts()
    lp32, _ = forward(folded, None)
    valid = torch.arange(lp16.shape[1], device=dev)[None] < out_lens[:, None]
    d = float(((lp16 - lp32).abs() * valid[..., None]).max())
    agree = float(((lp16.argmax(-1) == lp32.argmax(-1)) & valid).sum()
                  / valid.sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        forward(bf16, torch.bfloat16)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    dev_ms = event_ms(lambda: forward(bf16, torch.bfloat16), reps=5)
    rows = device_profile(lambda: forward(bf16, torch.bfloat16), reps=3)
    busy = sum(r[0] for r in rows)
    groups = device_time_by_group(rows, JASPER_GROUPS)
    # the forward's convolutions that are no plain 1x1 GEMM
    n_conv = sum(b.repeat for b in cfg.encoder.blocks
                 if b.effective_kernel > 1 or b.stride > 1)
    conv_seen = sum(c for _, c, key in rows
                    if any(w in key.lower() for w in ("convolve", "fprop")))
    flops = jasper_flops(cfg.encoder, int(flens.max()), 8)
    print(f"jasper10x5dr: {n_params} params (paper ~{JASPER_PAPER_PARAMS:.0f})"
          f"; B = 8 x 16.7 s bf16 forward (BN folded) vs fp32: frame argmax "
          f"{agree:.4f}, max |d log p| {d:.4e} (bound {E2E_LOGP_TOL}); "
          f"launches {counts}; {wall:.3f} ms wall, {dev_ms:.3f} ms on the "
          f"card by CUDA events behind a sleep kernel "
          f"({100 * (1 - dev_ms / wall):.1f} % idle), "
          f"{flops / 1e12:.3f} TFLOP of convolutions = "
          f"{flops / dev_ms / 1e9:.1f} TFLOP/s, "
          f"{8 * 16.7 / wall * 1e3:.1f} audio-s/s")
    if conv_seen == n_conv:
        print(f"  device time by group (CUPTI, {busy:.4f} ms a call):")
        for g, ms in groups.items():
            print(f"    {g:<28} {ms:9.4f} ms")
    else:
        # CUPTI's durations are then no device times: the groups' shares of
        # its sum only, scaled to the events' time and labelled so
        print(f"  device time by group: not measured (CUPTI saw "
              f"{conv_seen:g} convolution launches a call for the forward's "
              f"{n_conv} and sums {busy:.4f} ms against the events' "
              f"{dev_ms:.4f}); CUPTI's shares scaled to the event time:")
        for g, ms in groups.items():
            print(f"    {g:<28} {100 * ms / busy:6.2f} % = "
                  f"{ms / busy * dev_ms:9.4f} ms (scaled)")
    for ms, count, key in rows[:6]:
        print(f"  {ms:8.4f} ms  x{count:<5g} {key[:100]}")
    check(d <= E2E_LOGP_TOL, f"jasper: bf16 vs fp32 |d log p| {d}")
    check(counts["repeat_block"] == 0, f"jasper: launches {counts}")

    # 3 LAMB steps at B = 8
    small = dataclasses.replace(batch, signal=batch.signal[:8],
                                signal_lens=batch.signal_lens[:8],
                                tokens=batch.tokens[:8],
                                token_lens=batch.token_lens[:8])
    del folded, bf16
    path_kernel_check(torch, dev, cfg, variables, small, "jasper train",
                      torch.bfloat16)
    state = TrainState.create(variables, make_optimizer(
        "lamb", 1e-3, weight_decay=0.001))
    tr = Trainer(cfg, compute_dtype="bfloat16", log_every=1, device=dev)
    tr.fit(state, [small])
    reset_conformer_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.fit(state, [small] * 3)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    counts = conformer_counts()
    losses = [h["loss"] for h in tr.history if "loss" in h]
    print(f"jasper10x5dr train: LAMB, bf16, B = 8 x 16.7 s: losses "
          f"{[round(x, 3) for x in losses]}, {step_ms:.2f} ms a step "
          f"({8 * 16.7 / step_ms * 1e3:.1f} trained audio-s/s in padded "
          f"seconds), launches {counts} for 3 steps, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, skipped "
          f"{int(state.skipped_steps)}")
    check(all(np.isfinite(losses)) and int(state.skipped_steps) == 0,
          f"jasper train: losses {losses}")
    check(counts["ctc_alpha"] == 3 and counts["ctc_beta"] == 3
          and counts["log_mel_frontend"] == 3
          and counts["repeat_block"] == 0,
          f"jasper train: launches {counts}")
    add_path_launches(kernels, "jasper_train", counts)


def conformer_train_phase(np, torch, dev, kernels, config=os.path.join(
        HERE, "vietasr_tpu_torch", "configs", "conformer_ctc_vi.yaml")):
    """Phase 12d: conformer_ctc_vi at full width, 3 steps at B = 16 with
    dropout, without and with remat; remat's gradients against none's."""
    import dataclasses

    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.models import model_init
    from vietasr_tpu_torch.models.quartznet import map_tree, tree_leaves
    from vietasr_tpu_torch.train import (TrainState, Trainer,
                                         make_optimizer)
    from vietasr_tpu_torch.train.loop import batch_to_tensors, make_loss_fn

    cfg = load_config(config)
    full = train_batch(np, cfg)
    batch = dataclasses.replace(full, signal=full.signal[:16],
                                signal_lens=full.signal_lens[:16],
                                tokens=full.tokens[:16],
                                token_lens=full.token_lens[:16])
    variables = model_init(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    path_kernel_check(torch, dev, cfg, variables, batch, "conformer train",
                      torch.bfloat16)
    for remat in (False, True):
        state = TrainState.create(variables, make_optimizer(
            "adamw", 1e-4, weight_decay=0.001))
        tr = Trainer(cfg, compute_dtype="bfloat16", log_every=1, device=dev,
                     remat=remat)
        tr.fit(state, [batch])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_conformer_counts()
        t0 = time.perf_counter()
        tr.fit(state, [batch] * 3)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        counts = conformer_counts()
        losses = [h["loss"] for h in tr.history if "loss" in h]
        print(f"conformer train (remat={remat}): dropout "
              f"{cfg.conformer.dropout}, bf16, B = 16 x 16.7 s: losses "
              f"{[round(x, 3) for x in losses]}, {step_ms:.2f} ms a step, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
              f" GiB, launches {counts} for 3 steps")
        check(all(np.isfinite(losses)) and int(state.skipped_steps) == 0,
              f"conformer train: losses {losses}")
        check(counts["ctc_alpha"] == 3 and counts["ctc_beta"] == 3
              and counts["log_mel_frontend"] == 3,
              f"conformer train: launches {counts}")
        if not remat:
            add_path_launches(kernels, "conformer_train", counts)

    # dropout and dither 0, fp32, one batch: the gradients with and
    # without remat
    nodrop = dataclasses.replace(
        cfg, conformer=dataclasses.replace(cfg.conformer, dropout=0.0),
        featurizer=dataclasses.replace(cfg.featurizer, dither=0.0))
    tensors = batch_to_tensors(batch, dev)
    ptree = map_tree(lambda p: p.detach().clone().requires_grad_(True),
                     variables["params"])
    params = tree_leaves(ptree)
    grads = {}
    torch.backends.cudnn.deterministic = True
    for remat in (False, True):
        loss_fn = make_loss_fn(nodrop, use_specaug=False, device=dev,
                               remat=remat)
        loss, _ = loss_fn(ptree, variables["batch_stats"], tensors, None,
                          True)
        grads[remat] = torch.autograd.grad(loss, params)
    torch.backends.cudnn.deterministic = False
    worst = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                for a, b in zip(grads[False], grads[True]))
    print(f"conformer remat vs none (fp32, dropout 0): largest relative "
          f"gradient difference {worst:.3e} over {len(params)} leaves "
          f"(bound {REMAT_GRAD_RTOL})")
    check(worst <= REMAT_GRAD_RTOL, f"conformer remat gradients {worst}")


def phase12(np, torch, dev, kernels):
    with tempfile.TemporaryDirectory() as tmp:
        cli_phase(np, torch, dev, kernels, tmp)
    jasper_phase(np, torch, dev, kernels)
    conformer_train_phase(np, torch, dev, kernels)


# ---------------------------------------------------------------------------
# phase 13: data and tensor parallelism, export, long-form on a Conformer

PHASE13_WORLD = 2
# the tensor-parallel Conformer forward vs the replicated one, fp32 (the
# JAX package's own TP bar, tests/test_tp.py)
TP_TOL = 2e-4
# the 2-rank and the world-size-1 NCCL DP steps vs the one-process step
# (3 steps, in bf16 and in fp32, cuDNN deterministic): (step 1's gradient
# norm, the losses, the params and BN running stats), relative, as phase
# 8's kernel-vs-plain bars (TRAIN_ROUTE_TOLS), since both differ only in
# summation order (BN sums and gradients reduced per rank, the BN mean as
# sum / n where one process takes torch.mean). Novograd scales each
# tensor's gradient by its own norm, so step 1's gradient norm is what
# holds the reduction's scale (a wrong scale is off by 1/2 or more). In
# bf16 that norm is taken over a forward whose activations round
# differently (phase 8's runs the same forward twice), so it gets the
# losses' bf16 bar: 2 ranks read 1.734e-3 on the H100.
DP_TOLS = {None: TRAIN_ROUTE_TOLS[None],
           "bfloat16": (2.0 ** -8,) + TRAIN_ROUTE_TOLS["bfloat16"][1:]}
DP_DTYPES = {"bf16": "bfloat16", "fp32": None}
# the world-size-1 NCCL step timed against the plain step in turns:
# rounds of steps each way, the median round
DP_TIME_ROUNDS, DP_TIME_STEPS = 5, 4
RANK_LIMIT_S = 420.0
# phase 8's step ms, for phase 13's DP steps beside it
PHASE8 = {}


def _rank_entry(fn_name, rank, world, tmp):
    """A spawned rank: runs globals()[fn_name](rank, world, tmp) and saves
    its result (or its traceback) under tmp."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        out = globals()[fn_name](rank, world, tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w",
                  encoding="utf-8") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(torch, fn_name, tmp, world=PHASE13_WORLD):
    """`world` spawned ranks of fn_name, joined within RANK_LIMIT_S (killed
    past it); their results, or a raise with their tracebacks."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(fn_name, r, world, tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_LIMIT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errs = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                errs.append(f"rank {r}:\n{f.read()}")
    check(not hung and not errs and not any(p.exitcode for p in procs),
          f"{fn_name}: {len(hung)} rank(s) killed after {RANK_LIMIT_S} s, "
          f"exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errs))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def dp_setup(np, torch, dev):
    """Phase 13a's model, batch and step: QuartzNet12x1_vi at full width
    (init seed 0), bf16, Novograd on phase 8's schedule, phase 8's batch of
    32 x 16.7 s, dither and SpecAugment off (each rank would draw its own)."""
    import dataclasses

    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.models.quartznet import init_quartznet
    from vietasr_tpu_torch.train import (TrainState, make_optimizer,
                                         make_schedule)

    cfg = load_config(CONFIG)
    cfg = dataclasses.replace(cfg, featurizer=dataclasses.replace(
        cfg.featurizer, dither=0.0))
    batch = train_batch(np, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    variables = init_quartznet(gen, cfg.encoder, cfg.num_classes, device=dev)
    schedule = make_schedule("CosineAnnealing", 0.02, TRAIN_STEPS,
                             warmup_steps=TRAIN_WARMUP)
    state = TrainState.create(variables, make_optimizer(
        "novograd", schedule, weight_decay=0.001))
    return cfg, batch, variables, state


def dp_steps(torch, cfg, state, batch, dev, group, steps=3,
             dtype="bfloat16"):
    """`steps` train steps of `batch` (the kernels; compute dtype `dtype`,
    None for fp32): (losses, gradient norms, ms a step by the host
    clock)."""
    from vietasr_tpu_torch.train.loop import batch_to_tensors, make_train_step

    step = make_train_step(cfg, use_specaug=False,
                           compute_dtype=dtype and getattr(torch, dtype),
                           device=dev, group=group)
    t = batch_to_tensors(batch, dev)
    losses, norms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, t, None)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    return losses, norms, (time.perf_counter() - t0) / steps * 1e3


@contextlib.contextmanager
def cudnn_deterministic(torch):
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def dp_compare(torch, dev, name, got, ref, tol):
    """A DP run against the one-process run of the same steps: got / ref
    hold losses, norms, params and stats (ref's p0 and s0, the state
    before the steps). Prints the differences beside `tol` (DP_TOLS);
    returns a failure's message past them, else None."""
    from vietasr_tpu_torch.models.quartznet import tree_leaves
    from vietasr_tpu_torch.train.optim import global_norm

    tol_gn, tol_loss, tol_param = tol

    def rel(a, b, base):
        with torch.no_grad():
            num = global_norm([x.to(dev) - y for x, y in zip(a, b)])
            den = global_norm([y - z for y, z in zip(b, base)])
        return float(num / den)

    d_gn = abs(got["norms"][0] - ref["norms"][0]) / ref["norms"][0]
    d_loss = max(abs(x - y) / abs(y) for x, y in zip(got["losses"],
                                                     ref["losses"]))
    d_param = rel(tree_leaves(got["params"]), tree_leaves(ref["params"]),
                  ref["p0"])
    d_stats = rel(tree_leaves(got["stats"]), tree_leaves(ref["stats"]),
                  ref["s0"])
    print(f"{name}: step 1's gradient norm {got['norms'][0]:.6g} vs one "
          f"process {ref['norms'][0]:.6g} (relative {d_gn:.3e}, bar "
          f"{tol_gn:.0e}); losses {got['losses']} vs {ref['losses']} (max "
          f"relative {d_loss:.3e}, bar {tol_loss:.3e}); |p - p_one| / "
          f"|p_one - p_0| {d_param:.3e}, BN running stats |s - s_one| / "
          f"|s_one - s_0| {d_stats:.3e} (bar {tol_param})")
    if not (d_gn <= tol_gn and d_loss <= tol_loss and d_param <= tol_param
            and d_stats <= tol_param):
        return (f"{name}: {d_gn} / {d_loss} / {d_param} / {d_stats} from "
                "the one-process step")
    return None


def dp_run(np, torch, dev, group, batch_rows=None, dtype="bfloat16"):
    """3 steps from dp_setup's state on its batch (or rows
    `batch_rows` of it): losses, norms, step ms, params and stats after,
    p0 / s0 before."""
    from vietasr_tpu_torch.models.quartznet import map_tree, tree_leaves

    cfg, batch, variables, state = dp_setup(np, torch, dev)
    if batch_rows is not None:
        batch = rows_of(batch, *batch_rows)
    out = {"p0": [p.detach().clone() for p in state.param_list()],
           "s0": [s.clone() for s in tree_leaves(state.batch_stats)]}
    with cudnn_deterministic(torch):
        out["losses"], out["norms"], out["step_ms"] = dp_steps(
            torch, cfg, state, batch, dev, group, dtype=dtype)
    out["params"] = map_tree(lambda p: p.detach().clone(), state.params)
    out["stats"] = map_tree(lambda p: p.clone(), state.batch_stats)
    return out, (cfg, batch, state)


def rows_of(batch, lo, hi):
    from vietasr_tpu_torch.audio import Batch

    return Batch(*(getattr(batch, k)[lo:hi] for k in
                   ("signal", "signal_lens", "tokens", "token_lens")))


def ctc_and_frontend_launches():
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.ops import fused_ctc as fc

    return {"log_mel_frontend": fused_log_mel_features.launches,
            "ctc_alpha": fc.fused_ctc_alpha.launches,
            "ctc_beta": fc.fused_ctc_beta.launches}


def reset_ctc_and_frontend():
    from vietasr_tpu_torch.frontend.cuda_frontend import fused_log_mel_features
    from vietasr_tpu_torch.ops import fused_ctc as fc

    for f in (fused_log_mel_features, fc.fused_ctc_alpha, fc.fused_ctc_beta):
        f.launches = 0


def parallel_ranks(rank, world, tmp):
    """Phase 13's ranks: 2 gloo processes sharing the one card (NCCL
    refuses two ranks on one device). (a) 3 data-parallel train steps on
    this rank's 16 of phase 8's 32 rows, the kernels this rank launched,
    and those kernels against their plain versions on this rank's batch;
    (b) the tensor-parallel conformer_ctc_vi forward (fp32, B = 8 x 16.7 s,
    the heads and FFN columns split over the 2 ranks) against the
    replicated forward."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.frontend.cuda_frontend import make_fused_featurizer
    from vietasr_tpu_torch.models import model_init
    from vietasr_tpu_torch.models.conformer import conformer_apply
    from vietasr_tpu_torch.models.quartznet import map_tree
    from vietasr_tpu_torch.parallel import initialize_multihost, make_mesh
    from vietasr_tpu_torch.parallel.tp import shard_conformer_variables

    dev = torch.device("cuda", 0)
    initialize_multihost("file://" + os.path.join(tmp, "store"), world, rank,
                         device=dev, backend="gloo")
    out = {}
    n = TRAIN_BATCH // world
    for key, dtype in DP_DTYPES.items():
        reset_ctc_and_frontend()
        run, (cfg, local, state) = dp_run(
            np, torch, dev, dist.group.WORLD, (rank * n, (rank + 1) * n),
            dtype)
        out[key] = {k: run[k] for k in ("losses", "norms", "step_ms")}
        out[key].update(
            launches=ctc_and_frontend_launches(),
            params=map_tree(lambda p: p.cpu(), run["params"]),
            stats=map_tree(lambda p: p.cpu(), run["stats"]))
        if dtype:
            path_kernel_check(torch, dev, cfg, state.variables, local,
                              f"dp rank {rank} ({n} rows)",
                              getattr(torch, dtype))

    ccfg = load_config(CONFORMER_CONFIG)
    gen = torch.Generator(device=dev).manual_seed(0)
    full = model_init(gen, ccfg, device=dev)
    mesh = make_mesh(num_data=1, num_model=world)
    shard = shard_conformer_variables(full, mesh)
    featurize = make_fused_featurizer(ccfg.featurizer, device=dev)
    rng = np.random.RandomState(31)
    sig = torch.from_numpy((rng.randn(8, 267200) * 0.1).astype(np.float32)) \
        .to(dev)
    lens = torch.from_numpy(rng.randint(80000, 267201, size=8)
                            .astype(np.int32)).to(dev)

    @torch.no_grad()
    def tp_forward():
        feats, flens = featurize(sig, lens)
        return conformer_apply(shard, feats, flens, cfg=ccfg.conformer,
                               tp_group=mesh.get_group("model"))

    tp_forward()
    torch.cuda.synchronize()
    reset_ctc_and_frontend()
    t0 = time.perf_counter()
    lp, enc_lens = tp_forward()
    torch.cuda.synchronize()
    out["tp_ms"] = (time.perf_counter() - t0) * 1e3
    out["tp_launches"] = ctc_and_frontend_launches()
    with torch.no_grad():
        feats, flens = featurize(sig, lens)
        want, want_lens = conformer_apply(full, feats, flens,
                                          cfg=ccfg.conformer)
    valid = (torch.arange(lp.shape[1], device=dev)[None]
             < enc_lens[:, None])[..., None]
    out["tp_err"] = float(((lp - want).abs() * valid).max())
    out["tp_lens_equal"] = bool(torch.equal(enc_lens, want_lens))
    out["tp_shape"] = tuple(lp.shape)
    out["tp_finite"] = bool(torch.isfinite(lp).all())
    return out


def dp_phase(np, torch, dev, kernels, tmp):
    """Phase 13a/b: the 2 gloo ranks (parallel_ranks) against the
    one-process step, then a world-size-1 NCCL group, each in bf16 and in
    fp32."""
    import torch.distributed as dist

    from vietasr_tpu_torch.models.quartznet import tree_leaves

    refs = {key: dp_run(np, torch, dev, None, dtype=dtype)[0]
            for key, dtype in DP_DTYPES.items()}
    failed = []
    ranks = run_ranks(torch, "parallel_ranks", tmp)
    a, b = ranks
    for key, dtype in DP_DTYPES.items():
        same = all(torch.equal(x, y) for part in ("params", "stats")
                   for x, y in zip(tree_leaves(a[key][part]),
                                   tree_leaves(b[key][part])))
        half = TRAIN_BATCH // 2
        print(f"dp {key}: 2 gloo ranks on one card, QuartzNet12x1_vi, 3 "
              f"steps of {half} + {half} of phase 8's {TRAIN_BATCH} rows: "
              f"the ranks' params and BN stats equal bit for bit: {same}; "
              f"launches per rank {a[key]['launches']}, "
              f"{b[key]['launches']}; ms a step on rank 0 (3 steps, the "
              f"first warming up) {a[key]['step_ms']:.2f}: gloo stages "
              f"every all-reduce through the host, not a scaling number")
        check(same, f"dp {key}: the ranks' parameters differ")
        failed.append(dp_compare(torch, dev, f"dp {key} 2 ranks", a[key],
                                 refs[key], DP_TOLS[dtype]))
        for r in ranks:
            check(r[key]["launches"] == {"log_mel_frontend": 3,
                                         "ctc_alpha": 3, "ctc_beta": 3},
                  f"dp {key}: a rank launched {r[key]['launches']} in 3 "
                  "steps")
    add_path_launches(kernels, "dp_train", a["bf16"]["launches"])

    print(f"tp: conformer_ctc_vi fp32 forward over 2 gloo ranks, B=8 x "
          f"16.7 s -> {a['tp_shape']}: max|d log p| vs the replicated "
          f"forward {a['tp_err']:.3e}, {b['tp_err']:.3e} (tol {TP_TOL}); "
          f"lengths equal {a['tp_lens_equal']}; {a['tp_ms']:.2f} ms (gloo, "
          f"host-staged); launches {a['tp_launches']}")
    for r in ranks:
        check(r["tp_finite"] and r["tp_lens_equal"]
              and r["tp_err"] <= TP_TOL, f"tp: rank result {r['tp_err']}")
        check(r["tp_launches"] == {"log_mel_frontend": 1, "ctc_alpha": 0,
                                   "ctc_beta": 0},
              f"tp: launches {r['tp_launches']}")
    add_path_launches(kernels, "tp_forward", a["tp_launches"])

    # a world-size-1 NCCL group: the same steps through the collectives
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "nccl1"), world_size=1, rank=0)
    try:
        for key, dtype in DP_DTYPES.items():
            reset_ctc_and_frontend()
            got, (cfg, batch, state) = dp_run(np, torch, dev,
                                              dist.group.WORLD, dtype=dtype)
            launches = ctc_and_frontend_launches()
            check(launches == {"log_mel_frontend": 3, "ctc_alpha": 3,
                               "ctc_beta": 3},
                  f"dp nccl {key}: launches {launches}")
            failed.append(dp_compare(torch, dev,
                                     f"dp {key} world-size-1 NCCL", got,
                                     refs[key], DP_TOLS[dtype]))
            if dtype == "bfloat16":
                add_path_launches(kernels, "dp_train_nccl1", launches)
                times = {"group": [], "none": []}
                for _ in range(DP_TIME_ROUNDS):
                    for k, g in (("group", dist.group.WORLD),
                                 ("none", None)):
                        times[k].append(dp_steps(torch, cfg, state, batch,
                                                 dev, g, DP_TIME_STEPS)[2])
    finally:
        dist.destroy_process_group()
    with_ms, without_ms = (float(np.median(times[k]))
                           for k in ("group", "none"))
    print(f"dp world-size-1 NCCL, bf16: ms a step with the group "
          f"{with_ms:.2f}, without {without_ms:.2f} "
          f"({100 * (with_ms / without_ms - 1):+.1f} %; median of "
          f"{DP_TIME_ROUNDS} rounds of {DP_TIME_STEPS} steps each way, in "
          f"turns: {times}), phase 8 "
          f"{PHASE8.get('step_ms', float('nan')):.2f}; the gradient "
          f"all-reduce's own time is not measurable on one rank (NCCL "
          f"moves nothing)")
    failed = [f for f in failed if f]
    check(not failed, "; ".join(failed))


def interleaved_ms(torch, fns: dict, rounds: int = 6, reps: int = 10):
    """Median host ms per call of each fn, timed in turns (a round times
    every fn over `reps` calls, synchronized at both ends)."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) / reps * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def export_phase(np, torch, dev, kernels, tmp):
    """Phase 13c: export_transcriber of the full-width QuartzNet12x1_vi
    Transcriber (the anchor, bf16) at B = 1 and 8 x the 16.7 s bucket,
    loaded back: outputs bit for bit with the eager forward, 1 frontend and
    13 repeat launches a forward, ms per forward beside the eager path's,
    and the eager forward through the custom ops vs the direct calls."""
    from vietasr_tpu_torch.export import export_transcriber, load_exported
    from vietasr_tpu_torch.ops import custom_ops
    from vietasr_tpu_torch.pipeline import Transcriber

    tr = Transcriber(CONFIG, checkpoint=ANCHOR)
    bucket = tr.buckets[-1]
    t0 = time.perf_counter()
    manifest = export_transcriber(tr, os.path.join(tmp, "export"),
                                  batch_sizes=(1, 8), buckets=[bucket])
    print(f"export: {[f['file'] for f in manifest['functions']]} in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(13)
    for f in manifest["functions"]:
        bsz = f["batch"]
        fn = load_exported(os.path.join(tmp, "export", f["file"]))
        sig = torch.from_numpy((rng.randn(bsz, bucket) * 0.1)
                               .astype(np.float32)).to(dev)
        lens = torch.from_numpy(np.linspace(bucket, bucket // 3, bsz)
                                .astype(np.int32)).to(dev)
        fn(sig, lens)
        torch.cuda.synchronize()
        reset_launches()
        got = fn(sig, lens)
        torch.cuda.synchronize()
        launches = read_launches()
        want = tr._forward(sig, lens)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"export B={bsz}: the loaded program's outputs differ "
              "from the eager forward")
        check(launches == {"log_mel_frontend": 1, "repeat_block": 13,
                           "beam_search": 0},
              f"export B={bsz}: launches {launches}")

        def eager_ops():
            with custom_ops.through_ops():
                tr._forward(sig, lens)

        ms = interleaved_ms(torch, {
            "loaded": lambda: fn(sig, lens),
            "eager": lambda: tr._forward(sig, lens),
            "eager_ops": eager_ops})
        slower = ms["eager_ops"] / ms["eager"] - 1
        print(f"export B={bsz} x 16.7 s: loaded program equal bit for bit "
              f"with the eager forward: {same}; launches {launches}; ms a "
              f"forward (median of 6 rounds of 10): loaded "
              f"{ms['loaded']:.3f}, eager {ms['eager']:.3f}, eager through "
              f"the custom ops {ms['eager_ops']:.3f} ({100 * slower:+.1f} %)")
        if bsz == 8:
            add_path_launches(kernels, "export_forward", launches)


def conformer_longform_phase(np, torch, dev, kernels, tmp):
    """Phase 13d: transcribe_long over 45-300 s on conformer_ctc_vi (full
    width, seeded init, bf16), greedy and device_beam (W = 100, the word
    3-gram): stitched frame counts equal the offline forward's grid, 1
    frontend launch a call (and 1 beam launch with device_beam), the beam
    kernel against the plain search on the 45 s posterior."""
    from vietasr_tpu_torch import streaming as lf
    from vietasr_tpu_torch.frontend.features import feature_seq_len
    from vietasr_tpu_torch.ops.device_beam import device_beam_search
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    lm_paths = train_word_lms(tmp)
    sigs = longform_signals(np)[0]
    tr = Transcriber(CONFORMER_CONFIG)
    chunk, overlap, grid = lf._longform_grid(tr, 15.0, 2.0)
    check(grid == tr.cfg.featurizer.hop_length * 4,
          f"conformer long-form grid {grid}")
    preps = [lf._prep_longform(tr, s, None, chunk, overlap) for s in sigs]
    counts = []
    for s, prep in zip(sigs, preps):
        lp, total = lf._run_fused(tr, prep, chunk, overlap, True)
        n = feature_seq_len(torch.tensor([len(s)]), tr.cfg.featurizer
                            .hop_length)
        for _ in range(2):                       # the two k3 s2 stages
            n = torch.div(n - 1, 2, rounding_mode="floor") + 1
        counts.append((int(total), int(n[0])))
        check(bool(torch.isfinite(lp[:int(total)]).all()),
              "conformer long-form: non-finite log-probs")
    print(f"conformer long-form: stitched frames vs the offline grid "
          f"{counts} for {[len(s) // 16000 for s in sigs]} s")
    check(all(a == b for a, b in counts), f"conformer long-form frames "
          f"{counts}")
    tr.transcribe_long_batch(sigs)                     # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tr.transcribe_long_batch(sigs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check(launches == {"log_mel_frontend": len(sigs), "repeat_block": 0,
                       "beam_search": 0},
          f"conformer long-form launches {launches}")
    add_path_launches(kernels, "conformer_longform", launches)
    rows = device_profile(lambda: tr.transcribe_long_batch(sigs), reps=1)
    busy = sum(r[0] for r in rows)
    audio_s = sum(len(s) for s in sigs) / 16000
    print(f"conformer long-form greedy: {audio_s:.0f} audio-s in "
          f"{dt * 1e3:.2f} ms = {audio_s / dt:.1f} audio-s/s; device busy "
          f"{busy:.4f} ms ({100 * (1 - busy / (dt * 1e3)):.1f} % idle); "
          f"launches {launches}")

    bt = Transcriber(CONFORMER_CONFIG, options=TranscriberOptions(
        decoder="device_beam", lm_path=lm_paths[3]))
    bt.transcribe_long(sigs[1])                        # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    bt.transcribe_long(sigs[1])
    torch.cuda.synchronize()
    dt_b = time.perf_counter() - t0
    b_launches = read_launches()
    print(f"conformer long-form device beam (W={bt.opts.beam_width}, word "
          f"3-gram), 90 s: {dt_b * 1e3:.2f} ms = {90 / dt_b:.1f} "
          f"audio-s/s, launches {b_launches}")
    check(b_launches == {"log_mel_frontend": 1, "repeat_block": 0,
                         "beam_search": 1},
          f"conformer long-form device beam launches {b_launches}")
    add_path_launches(kernels, "conformer_longform", {
        k: launches[k] + b_launches[k] for k in launches})
    lp, total = lf._run_fused(bt, preps[0], chunk, overlap, True)
    labels = bt.cfg.labels
    kw = dict(blank=len(labels), beam_width=bt.opts.beam_width,
              word_lm=bt._device_word_lm, wlm_probes=bt._device_wlm_probes,
              space=labels.index(" "), return_raw=True, **BEAM_KW)
    lens = total.reshape(1).to(torch.int32)
    got = fused_beam_search(lp[None].float().contiguous(), lens, **kw)
    want = device_beam_search(lp[None].float().contiguous(), lens, **kw)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"conformer long-form beam kernel B=1 T={int(total)} (45 s) vs "
          f"the plain search: raw result equal bit for bit: {same}")
    check(same, "conformer long-form beam kernel differs from the plain "
          "search")


def phase13(np, torch, dev, kernels):
    with tempfile.TemporaryDirectory() as tmp:
        dp_phase(np, torch, dev, kernels, tmp)
        export_phase(np, torch, dev, kernels, tmp)
        conformer_longform_phase(np, torch, dev, kernels, tmp)


COPY_VOCAB, COPY_HIDDEN, COPY_LEN = 8, 32, 5
COPY_STEPS = 150
COPY_LOSS_MAX, COPY_ACC_MIN = 0.3, 0.8


def copy_task(np, torch, dev):
    """The seq2seq copy task (the JAX package's convergence check in
    tests/test_seq2seq.py): a GRU encoder over embedded ids 3..7 of
    length 5 and the attention decoder learn to emit the same ids, 150
    Adam steps (lr 5e-3) of B = 16 with the port's make_optimizer, weights
    from torch.Generator seed 0, batches from RandomState(0). Returns the
    final loss and the greedy and beam (W = 4) token accuracy on 4 held-out
    sequences each."""
    from vietasr_tpu_torch.models import seq2seq as s2s
    from vietasr_tpu_torch.models.quartznet import tree_leaves
    from vietasr_tpu_torch.ops.losses import sequence_loss
    from vietasr_tpu_torch.train.optim import make_optimizer

    v, h, n = COPY_VOCAB, COPY_HIDDEN, COPY_LEN
    bos, eos = 1, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"enc": s2s.init_encoder_rnn(gen, h, h, device=dev),
              "dec": s2s.init_decoder_rnn(gen, v, h, device=dev),
              "in_emb": 0.1 * torch.randn((v, h), generator=gen, device=dev)}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = make_optimizer("adam", 5e-3)(leaves)
    rng = np.random.RandomState(0)

    def encode(seq):
        lens = torch.full((seq.shape[0],), n, dtype=torch.int32, device=dev)
        enc_out, state = s2s.encoder_rnn_apply(params["enc"],
                                               params["in_emb"][seq], lens)
        return enc_out, state, lens

    loss = None
    for _ in range(COPY_STEPS):
        seq = torch.from_numpy(rng.randint(3, v, size=(16, n))
                               .astype(np.int64)).to(dev)
        enc_out, state, lens = encode(seq)
        tgt_in = torch.cat([torch.full_like(seq[:, :1], bos), seq[:, :-1]],
                           dim=1)
        lps = s2s.decoder_rnn_apply(params["dec"], tgt_in, state, enc_out,
                                    lens)
        loss = sequence_loss(lps, seq, lens, pad_id=0)
        opt.zero_grad()
        loss.backward()
        opt.step()
    out = {"loss": float(loss.detach())}
    with torch.no_grad():
        for name, seed in (("greedy", 7), ("beam", 8)):
            seq = torch.from_numpy(np.random.RandomState(seed).randint(
                3, v, size=(4, n)).astype(np.int64)).to(dev)
            enc_out, state, lens = encode(seq)
            kw = dict(bos_id=bos, eos_id=eos, max_len=n)
            if name == "greedy":
                toks, _ = s2s.greedy_generate(params["dec"], state, enc_out,
                                              lens, **kw)
            else:
                toks, scores = s2s.beam_generate(params["dec"], state,
                                                 enc_out, lens,
                                                 beam_width=4, **kw)
                out["beam_scores_finite"] = bool(torch.isfinite(scores)
                                                 .all())
            out[f"{name}_acc"] = float((toks[:, :n].long() == seq)
                                       .float().mean())
    return out


# phase 14: the tail of the JAX package on the card (Kaldi features into
# CTC, speech classification, LAS, the copy task, featurizer variants)

# Speech Commands v2's 35 words (the class count of its recipes)
SPEECH_COMMANDS = (
    "backward bed bird cat dog down eight five follow forward four go "
    "happy house learn left marvin nine no off on one right seven sheila "
    "six stop three tree two up visual wow yes zero").split()
CLASSIFY_CLIPS = 64
CLASSIFY_FRAMES = 128      # speech-command recipes crop or pad to 128
LAS_HIDDEN = 512           # a cut: the repo ships no LAS configuration
LAS_SPECIALS = 3           # pad 0, bos 1, eos 2, then the anchor's labels
LAS_BEAM, LAS_MAX_LEN = 8, 200
LAS_TF_TOL = 1e-4          # teacher-forced log-probs, card vs CPU, fp32
# spectrogram / MFCC, card vs CPU (tests/test_torch_variants.py's bars):
# power within 1e-5 of each frame's largest (and so is each from an fp64
# chain); features within 2e-4 on the bins at or above 1e-6 of their
# frame's largest power
VARIANT_POWER_RTOL, VARIANT_TOL, VARIANT_WELL = 1e-5, 2e-4, 1e-6
KERNEL_NAMES = ("log_mel_frontend", "frontend_fast", "repeat_block",
                "repeat_whole_block", "beam_search", "ctc_alpha", "ctc_beta")


def _kernel_wrappers():
    from vietasr_tpu_torch.frontend import cuda_frontend as cf
    from vietasr_tpu_torch.ops import fused_ctc as fc
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                    repeat_whole_block_cuda)

    return dict(zip(KERNEL_NAMES, (
        cf.fused_log_mel_features, cf.log_mel_tiles_fast_cuda,
        fused_repeat_block, repeat_whole_block_cuda, fused_beam_search,
        fc.fused_ctc_alpha, fc.fused_ctc_beta)))


def reset_all_launches():
    for f in _kernel_wrappers().values():
        f.launches = 0


def all_launches() -> dict:
    return {k: f.launches for k, f in _kernel_wrappers().items()}


def check_launches(kernels, path: str, launches: dict, want: dict) -> None:
    """`launches` of every kernel equal `want` (0 where not named); then
    recorded as the kernels' path_launches[path]."""
    full = {k: want.get(k, 0) for k in KERNEL_NAMES}
    check(launches == full, f"{path}: launches {launches}, want {full}")
    add_path_launches(kernels, path, launches)


def padded_batch(np, signals, samples):
    batch = np.zeros((len(signals), samples), np.float32)
    for row, s in enumerate(signals):
        batch[row, :len(s)] = s[:samples]
    return batch, np.array([min(len(s), samples) for s in signals], np.int32)


def encoder_output(variables, ecfg, compute_dtype, feats, flens):
    """A QuartzNet encoder's last block output (B, T', C), taken at the
    head's 1x1 call site through the `pw_fn` hook (JAX offers no other
    way to it); the per-op blocks run, as in JAX, since the fused route
    needs the default pw_fn. Returns (encoded, enc_lens)."""
    from vietasr_tpu_torch.models.layers import pointwise_conv
    from vietasr_tpu_torch.models.quartznet import quartznet_apply

    seen = {}

    def capture(tag, x, w):
        if tag == "dec":
            seen["enc"] = x
        return pointwise_conv(x, w)

    _, enc_lens = quartznet_apply(variables, feats, flens, cfg=ecfg,
                                  compute_dtype=compute_dtype, pw_fn=capture)
    return seen["enc"], enc_lens


def cm_scp(path, records) -> str:
    """An scp for a CM ark written by write_compressed_ark: each record's
    offset, past its "key " (the CM record's layout: "\\0BCM ", 16 bytes of
    global header, 8 per column, one per element)."""
    lines, pos = [], 0
    for key, mat in records.items():
        pos += len(key.encode("utf-8")) + 1
        lines.append(f"{key} {path}:{pos}")
        rows, cols = mat.shape
        pos += 5 + 16 + 8 * cols + rows * cols
    scp = path + ".scp"
    with open(scp, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return scp


def cm_error_bounds(np, ark):
    """Per record and column, half a code step of the widest of the three
    CM segments as the file's header decodes them, and the header's own
    fp32 rounding: {key: (cols,) bound}."""
    import struct

    out = {}
    with open(ark, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        sp = data.index(b" ", pos)
        key = data[pos:sp].decode("utf-8")
        pos = sp + 1 + 5
        mn, rng = struct.unpack("<ff", data[pos:pos + 8])
        rows, cols = struct.unpack("<ii", data[pos + 8:pos + 16])
        pos += 16
        hdr = np.frombuffer(data[pos:pos + 8 * cols], "<u2").reshape(cols, 4)
        pos += 8 * cols + rows * cols
        p = mn + rng * hdr.astype(np.float64) / 65535.0
        half = np.maximum.reduce([(p[:, 1] - p[:, 0]) / 128.0,
                                  (p[:, 2] - p[:, 1]) / 256.0,
                                  (p[:, 3] - p[:, 2]) / 126.0])
        out[key] = half + 4 * 2.0 ** -24 * (abs(mn) + abs(rng))
    return out


def kaldi_ctc_phase(np, torch, dev, signals, kernels, tmp):
    """Phase 14a: phase 5's 16 signals featurized in one padded batch on
    the frontend kernel, written as an FM ark + scp and a CM ark with a
    text file of VI_CORPUS lines, read back through KaldiFeatureDataset,
    padded to the in-memory batch's frames and forwarded through the anchor
    on the repeat kernel, decoded by greedy_transcripts."""
    from vietasr_tpu_torch.audio import kaldi
    from vietasr_tpu_torch.audio.tokenizer import CharTokenizer
    from vietasr_tpu_torch.models import quartznet as qn
    from vietasr_tpu_torch.ops.greedy import greedy_transcripts
    from vietasr_tpu_torch.pipeline import Transcriber

    tr = Transcriber(CONFIG, checkpoint=ANCHOR)
    fcfg, ecfg = tr.cfg.featurizer, tr.cfg.encoder
    labels = tr.cfg.labels
    batch, lens_np = padded_batch(np, signals, tr.buckets[-1])
    sig = torch.from_numpy(batch).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    audio_s = float(lens_np.sum()) / fcfg.sample_rate

    def forward(feats, flens):
        return qn.quartznet_apply(tr.variables, feats, flens, cfg=ecfg,
                                  compute_dtype=tr.compute_dtype)

    tr._featurize(sig, lens)
    forward(*tr._featurize(sig, lens))          # warm-up
    torch.cuda.synchronize()
    reset_all_launches()
    feats, flens = tr._featurize(sig, lens)
    front_launches = all_launches()
    records = {f"utt{i:02d}": feats[i, :int(flens[i])].cpu().numpy()
               for i in range(len(signals))}
    check(not bool(torch.stack([feats[i, int(flens[i]):].abs().sum()
                                for i in range(len(signals))]).any()),
          "kaldi_ctc: the in-memory features are not zero past seq_len")
    fm_ark = os.path.join(tmp, "feats.ark")
    fm_scp = os.path.join(tmp, "feats.scp")
    cm_ark = os.path.join(tmp, "feats_cm.ark")
    text = os.path.join(tmp, "text")
    kaldi.write_ark(fm_ark, records, fm_scp)
    kaldi.write_compressed_ark(cm_ark, records)
    with open(text, "w", encoding="utf-8") as f:
        f.writelines(f"{k} {VI_CORPUS[i]}\n" for i, k in enumerate(records))
    tok = CharTokenizer(labels)

    def read(scp):
        t0 = time.perf_counter()
        ds = kaldi.KaldiFeatureDataset(scp, text, tok)
        t = feats.shape[1]
        x = np.zeros((len(ds), t, feats.shape[2]), np.float32)
        n = np.zeros((len(ds),), np.int32)
        for row in range(len(ds)):
            _, m, _ = ds[row]
            x[row, :len(m)] = m
            n[row] = len(m)
        out = (torch.from_numpy(x).to(dev), torch.from_numpy(n).to(dev))
        return ds, out, (time.perf_counter() - t0) * 1e3

    ds, (x_fm, n_fm), read_ms = read(fm_scp)
    check(len(ds) == len(records) and ds.num_dropped == 0,
          f"kaldi_ctc: the FM dataset holds {len(ds)}, dropped "
          f"{ds.num_dropped}")
    check(all(np.array_equal(ds[i][1], records[k])
              and ds[i][0] == k and tok.decode(ds[i][2]) == VI_CORPUS[i]
              for i, k in enumerate(records)),
          "kaldi_ctc: the FM round trip is not bit for bit")
    check(torch.equal(x_fm, feats) and torch.equal(n_fm, flens),
          "kaldi_ctc: the padded FM batch differs from the in-memory one")
    calls, undo = record_repeat_calls(qn)
    try:
        lp_fm, el_fm = forward(x_fm, n_fm)
    finally:
        undo()
    torch.cuda.synchronize()
    launches = all_launches()
    check_launches(kernels, "kaldi_ctc", launches,
                   {"log_mel_frontend": 1, "repeat_block": 13})
    check(front_launches["log_mel_frontend"] == 1,
          f"kaldi_ctc: featurizing launched {front_launches}")
    f_err = hold_frontend(torch, fcfg, sig, lens, feats, flens, "kaldi_ctc")
    r_err = hold_repeat(calls, "kaldi_ctc")
    check(len(calls) == 13, f"kaldi_ctc: {len(calls)} repeat calls")
    lp_mem, el_mem = forward(feats, flens)
    check(torch.equal(lp_fm, lp_mem) and torch.equal(el_fm, el_mem),
          "kaldi_ctc: log-probs from the FM ark differ from the in-memory "
          "features'")
    texts = greedy_transcripts(lp_fm, el_fm, labels)

    ds_cm, (x_cm, n_cm), read_cm_ms = read(cm_scp(cm_ark, records))
    bounds = cm_error_bounds(np, cm_ark)
    worst = 0.0
    for i, k in enumerate(records):
        err = np.abs(ds_cm[i][1] - records[k]).max(axis=0)
        worst = max(worst, float((err / bounds[k]).max()))
    check(worst <= 1.0, f"kaldi_ctc: CM decode error {worst} x its bound")
    lp_cm, el_cm = forward(x_cm, n_cm)
    agree_cm = float(sum((lp_cm[i, :n].argmax(-1) == lp_fm[i, :n].argmax(-1))
                         .sum() for i, n in enumerate(el_fm.tolist()))
                     / float(el_fm.sum()))
    cm_texts = greedy_transcripts(lp_cm, el_cm, labels)

    fwd_ms = interleaved_ms(torch, {"fwd": lambda: forward(x_fm, n_fm)},
                            rounds=3, reps=5)["fwd"]
    print(f"phase 14a kaldi -> CTC: 16 signals ({audio_s:.1f} audio-s) -> "
          f"features {tuple(feats.shape)}; FM ark + scp and CM ark of "
          f"{os.path.getsize(fm_ark)} / {os.path.getsize(cm_ark)} bytes; "
          f"FM round trip bit for bit, log-probs from the FM ark equal the "
          f"in-memory forward's: True; launches {launches}; frontend vs "
          f"plain max|d| {f_err:.3e} (tol {FRONTEND_TOL}), repeat max|d| / "
          f"max|want| {r_err:.3e} (tol {REPEAT_TOL_REL:.3e}) over 13 "
          f"launches at B = {x_fm.shape[0]} x T = {x_fm.shape[1]}")
    print(f"phase 14a CM: decode error max {worst:.4f} x (half a code step "
          f"of the column's widest segment + fp32 header rounding); frame "
          f"argmax agreement with the FM path {agree_cm:.4f}; transcripts "
          f"equal {sum(a == b for a, b in zip(texts, cm_texts))}/"
          f"{len(texts)}; ms: FM read {read_ms:.2f}, CM read "
          f"{read_cm_ms:.2f}, forward {fwd_ms:.3f} (host clock, median); "
          f"{audio_s / ((read_ms + fwd_ms) / 1e3):.1f} audio-s/s read + "
          f"forward, {audio_s / (fwd_ms / 1e3):.1f} forward alone")
    return tr


def write_commands(np, folder):
    """CLASSIFY_CLIPS seeded 1 s PCM16 WAVs named for SPEECH_COMMANDS
    labels (every label at least once): [ManifestEntry]."""
    from scipy.io import wavfile

    from vietasr_tpu_torch.audio.manifest import ManifestEntry

    rng = np.random.RandomState(14)
    names = list(SPEECH_COMMANDS) + list(rng.choice(
        SPEECH_COMMANDS, CLASSIFY_CLIPS - len(SPEECH_COMMANDS)))
    entries = []
    for i, name in enumerate(names):
        path = os.path.join(folder, f"cmd{i:02d}.wav")
        x = (rng.randn(16000) * 0.1 * 32767).clip(-32768, 32767)
        wavfile.write(path, 16000, x.astype(np.int16))
        entries.append(ManifestEntry(path, 1.0, name))
    return entries


def classify_phase(np, torch, dev, tr, kernels, tmp):
    """Phase 14b: 64 clips through AudioLabelDataset into one B = 64 batch,
    the log-mel on the frontend kernel, crop_or_pad_spectrogram to 128
    frames, the anchor's encoder output (pw_fn capture: per-op blocks, no
    repeat launch), the classifier head (1024 -> 35, seed 0) with avg and
    max pooling, cross entropy and top-1 / top-5 accuracy; bf16 against
    the same path in fp32."""
    from vietasr_tpu_torch.audio.dataset import AudioLabelDataset
    from vietasr_tpu_torch.frontend.variants import crop_or_pad_spectrogram
    from vietasr_tpu_torch.models.classifier import (classification_accuracy,
                                                     classifier_apply,
                                                     init_classifier_head)
    from vietasr_tpu_torch.ops.losses import cross_entropy_loss
    from vietasr_tpu_torch.utils.device import strict_fp32

    ds = AudioLabelDataset(write_commands(np, tmp), SPEECH_COMMANDS)
    check(len(ds) == CLASSIFY_CLIPS and ds.num_dropped == 0,
          f"classify: dataset of {len(ds)}, dropped {ds.num_dropped}")
    items = [ds[i] for i in range(len(ds))]
    batch, lens_np = padded_batch(np, [s for s, _ in items], 16000)
    sig = torch.from_numpy(batch).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    target = torch.tensor([l for _, l in items], device=dev)
    c = tr.variables["params"]["decoder"]["w"].shape[0]
    head = init_classifier_head(torch.Generator(device=dev).manual_seed(0),
                                c, len(SPEECH_COMMANDS), device=dev)

    def run(variables=tr.variables, dtype=tr.compute_dtype):
        feats, flens = tr._featurize(sig, lens)
        feats, flens = crop_or_pad_spectrogram(
            feats, flens, audio_length=CLASSIFY_FRAMES)
        enc, enc_lens = encoder_output(variables, tr.cfg.encoder, dtype,
                                       feats, flens)
        out = {"feats": feats, "flens": flens}
        for pooling in ("avg", "max"):
            logits = classifier_apply(head, enc.float(), enc_lens,
                                      pooling=pooling)
            out[pooling] = (logits, cross_entropy_loss(logits, target),
                            classification_accuracy(logits, target, (1, 5)))
        return out

    run()
    torch.cuda.synchronize()
    reset_all_launches()
    got = run()
    torch.cuda.synchronize()
    launches = all_launches()
    check_launches(kernels, "classify", launches, {"log_mel_frontend": 1})
    feats, flens = tr._featurize(sig, lens)     # the kernel vs its plain
    f_err = hold_frontend(torch, tr.cfg.featurizer, sig, lens, feats, flens,
                          "classify")
    check(got["feats"].shape == (CLASSIFY_CLIPS, CLASSIFY_FRAMES,
                                 tr.cfg.featurizer.features)
          and bool((got["flens"] == CLASSIFY_FRAMES).all()),
          f"classify: crop_or_pad gave {tuple(got['feats'].shape)}")
    with strict_fp32():
        ref = run(tr._float_variables, None)
    ms = interleaved_ms(torch, {"batch": run}, rounds=3, reps=3)["batch"]
    for pooling in ("avg", "max"):
        logits, loss, acc = got[pooling]
        ref_logits = ref[pooling][0]
        check(bool(torch.isfinite(loss)) and bool(torch.isfinite(logits)
                                                  .all()),
              f"classify {pooling}: loss {float(loss)}")
        d = float((logits - ref_logits).abs().max())
        agree = float((logits.argmax(-1) == ref_logits.argmax(-1))
                      .float().mean())
        print(f"phase 14b classify ({pooling} pooling): B = "
              f"{CLASSIFY_CLIPS} x 1 s -> {CLASSIFY_FRAMES} frames, logits "
              f"{tuple(logits.shape)}; bf16 vs fp32 max|d logit| {d:.4e}, "
              f"argmax agreement {agree:.4f}; cross entropy "
              f"{float(loss):.4f} (fp32 {float(ref[pooling][1]):.4f}); "
              f"top-1 / top-5 accuracy {acc[0]:.4f} / {acc[1]:.4f} (random "
              f"weights)")
    print(f"phase 14b classify: launches {launches}; frontend vs plain "
          f"max|d| {f_err:.3e}; {ms:.3f} ms a batch (featurize, crop, "
          f"encoder, both heads, loss and accuracy; host clock, median)")


def las_parts(torch, gen, c_in, vocab, dev):
    from vietasr_tpu_torch.models import seq2seq as s2s

    return {"conn": s2s.init_jasper_rnn_connector(gen, c_in, LAS_HIDDEN,
                                                  device=dev),
            "enc": s2s.init_encoder_rnn(gen, LAS_HIDDEN, LAS_HIDDEN,
                                        device=dev),
            "dec": s2s.init_decoder_rnn(gen, vocab, LAS_HIDDEN, device=dev)}


def las_encode(parts, encoded, enc_lens):
    from vietasr_tpu_torch.models import seq2seq as s2s

    x, _ = s2s.jasper_rnn_connector_apply(parts["conn"], encoded, enc_lens)
    return s2s.encoder_rnn_apply(parts["enc"], x, enc_lens)


def las_phase(np, torch, dev, tr, signals, kernels):
    """Phase 14c: phase 5's B = 8 x 16.7 s batch on the frontend kernel,
    the anchor's encoder output (pw_fn capture), the connector 1024 ->
    512 (eval), a GRU encoder 512 -> 512 and the attention decoder
    (hidden 512, vocab 93), seed 0; greedy_generate and beam_generate
    (W = 8, max_len 200) and las_evaluate against VI_CORPUS; the
    teacher-forced log-probs and greedy tokens in fp32 against the same
    calls on the CPU."""
    from vietasr_tpu_torch.models import seq2seq as s2s
    from vietasr_tpu_torch.models.quartznet import map_tree
    from vietasr_tpu_torch.utils.device import strict_fp32

    labels = tr.cfg.labels
    vocab = LAS_SPECIALS + len(labels)
    bos, eos = 1, 2
    batch, lens_np = padded_batch(np, signals[:8], tr.buckets[-1])
    sig = torch.from_numpy(batch).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    refs = VI_CORPUS[:8]
    c = tr.variables["params"]["decoder"]["w"].shape[0]
    parts = las_parts(torch, torch.Generator(device=dev).manual_seed(0), c,
                      vocab, dev)

    def encode():
        feats, flens = tr._featurize(sig, lens)
        enc, enc_lens = encoder_output(tr.variables, tr.cfg.encoder,
                                       tr.compute_dtype, feats, flens)
        return feats, flens, enc.float(), enc_lens

    encode()
    torch.cuda.synchronize()
    reset_all_launches()
    feats, flens, enc, enc_lens = encode()
    with torch.no_grad():
        outs, h = las_encode(parts, enc, enc_lens)
    torch.cuda.synchronize()
    launches = all_launches()
    check_launches(kernels, "las", launches, {"log_mel_frontend": 1})
    f_err = hold_frontend(torch, tr.cfg.featurizer, sig, lens, feats, flens,
                          "las")
    kw = dict(bos_id=bos, eos_id=eos, max_len=LAS_MAX_LEN)
    times = {}
    with torch.no_grad():
        for name in ("greedy", "beam"):
            extra = {"beam_width": LAS_BEAM} if name == "beam" else {}
            fn = s2s.greedy_generate if name == "greedy" \
                else s2s.beam_generate
            fn(parts["dec"], h, outs, enc_lens, **kw, **extra)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, second = fn(parts["dec"], h, outs, enc_lens, **kw, **extra)
            torch.cuda.synchronize()
            times[name] = ((time.perf_counter() - t0) * 1e3, toks, second)
    ev = s2s.las_evaluate(times["beam"][1], refs,
                          [""] * LAS_SPECIALS + list(labels), eos_id=eos)
    check(all(np.isfinite([ev["wer"], ev["cer"]])),
          f"las: WER / CER {ev['wer']} / {ev['cer']}")

    # fp32 on the card vs the same calls on the CPU
    ids = [[bos] + [LAS_SPECIALS + labels.index(ch) for ch in r]
           for r in refs]
    width = max(map(len, ids))
    tgt = torch.tensor([r + [0] * (width - len(r)) for r in ids],
                       dtype=torch.int32)
    cpu = torch.device("cpu")
    parts_cpu = map_tree(lambda t: t.to(cpu), parts)
    with torch.no_grad(), strict_fp32():
        outs_d, h_d = las_encode(parts, enc, enc_lens)
        lp_d = s2s.decoder_rnn_apply(parts["dec"], tgt.to(dev), h_d, outs_d,
                                     enc_lens)
        greedy_d, glen_d = s2s.greedy_generate(parts["dec"], h_d, outs_d,
                                               enc_lens, **kw)
    with torch.no_grad():
        outs_c, h_c = las_encode(parts_cpu, enc.cpu(), enc_lens.cpu())
        lp_c = s2s.decoder_rnn_apply(parts_cpu["dec"], tgt, h_c, outs_c,
                                     enc_lens.cpu())
        greedy_c, glen_c = s2s.greedy_generate(parts_cpu["dec"], h_c, outs_c,
                                               enc_lens.cpu(), **kw)
    tf_err = float((lp_d.cpu() - lp_c).abs().max())
    check(tf_err <= LAS_TF_TOL, f"las: teacher-forced log-probs card vs CPU "
          f"max|d| {tf_err} > {LAS_TF_TOL}")
    same = torch.equal(greedy_d.cpu(), greedy_c)
    if same:
        diverge = "none"
    else:
        diff = (greedy_d.cpu() != greedy_c).any(0).nonzero()
        diverge = f"step {int(diff[0])}"
    g_ms, b_ms = times["greedy"][0], times["beam"][0]
    print(f"phase 14c LAS: encoder output {tuple(enc.shape)} (frames "
          f"{int(enc_lens.min())}-{int(enc_lens.max())}) -> connector "
          f"{c} -> {LAS_HIDDEN} -> GRU {LAS_HIDDEN} -> decoder {LAS_HIDDEN} "
          f"x {vocab}; launches {launches}; frontend vs plain max|d| "
          f"{f_err:.3e}; greedy {g_ms:.1f} ms ({g_ms / LAS_MAX_LEN:.3f} ms "
          f"a step), beam W = {LAS_BEAM} {b_ms:.1f} ms "
          f"({b_ms / LAS_MAX_LEN:.3f} ms a step), {LAS_MAX_LEN} steps; "
          f"greedy lengths {times['greedy'][2].tolist()}; las_evaluate on "
          f"the beam: WER {ev['wer']:.3f} CER {ev['cer']:.3f} (random "
          f"weights, a smoke value)")
    print(f"phase 14c LAS fp32 card vs CPU: teacher-forced log-probs "
          f"{tuple(lp_d.shape)} max|d| {tf_err:.3e} (tol {LAS_TF_TOL}); "
          f"greedy tokens equal: {same} (first divergence: {diverge}); "
          f"greedy lengths equal: {torch.equal(glen_d.cpu(), glen_c)}")


def copy_task_phase(np, torch, dev):
    """Phase 14d: the copy task trained on the card."""
    t0 = time.perf_counter()
    out = copy_task(np, torch, dev)
    check(out["loss"] < COPY_LOSS_MAX and out["greedy_acc"] > COPY_ACC_MIN
          and out["beam_acc"] > COPY_ACC_MIN and out["beam_scores_finite"],
          f"copy task: {out}")
    print(f"phase 14d copy task on the card: {COPY_STEPS} Adam steps, loss "
          f"{out['loss']:.4f} (< {COPY_LOSS_MAX}), greedy accuracy "
          f"{out['greedy_acc']:.3f}, beam (W = 4) {out['beam_acc']:.3f} "
          f"(> {COPY_ACC_MIN}), {time.perf_counter() - t0:.1f} s")


def variants_phase(np, torch, dev, tr, signals):
    """Phase 14e: the spectrogram and MFCCs (64 coefficients) at the
    anchor's featurizer on phase 5's B = 8 x 16.7 s batch, card vs CPU,
    timed beside the frontend kernel's log-mel."""
    from vietasr_tpu_torch.frontend import variants
    from vietasr_tpu_torch.frontend.features import (_windowed_dft_matrix,
                                                     preemphasize_and_pad)
    from vietasr_tpu_torch.utils.device import strict_fp32

    cfg = tr.cfg.featurizer
    batch, lens_np = padded_batch(np, signals[:8], tr.buckets[-1])
    sig_c, lens_c = torch.from_numpy(batch), torch.from_numpy(lens_np)
    sig, lens = sig_c.to(dev), lens_c.to(dev)
    spec = variants.make_spectrogram_featurizer(cfg, device=dev)
    mfcc = variants.make_mfcc_featurizer(cfg, 64, device=dev)
    with strict_fp32():
        s_d, s_len = spec(sig, lens)
        m_d, _ = mfcc(sig, lens)
        dft = torch.as_tensor(_windowed_dft_matrix(cfg), device=dev)
        p_d = variants._power_spectrum(sig, cfg, dft)
        spec64 = preemphasize_and_pad(sig.double(), cfg).unfold(
            1, cfg.fft_length, cfg.hop_length) @ dft.double()
        n_bins = cfg.fft_length // 2 + 1
        p64 = spec64[..., :n_bins] ** 2 + spec64[..., n_bins:] ** 2
    s_c, _ = variants.make_spectrogram_featurizer(cfg, device="cpu")(sig_c,
                                                                     lens_c)
    m_c, _ = variants.make_mfcc_featurizer(cfg, 64, device="cpu")(sig_c,
                                                                  lens_c)
    p_c = variants._power_spectrum(sig_c, cfg, dft.cpu())
    p64 = p64.cpu()
    scale = p64.max(dim=-1, keepdim=True).values
    valid = (torch.arange(p64.shape[1])[None, :, None]
             < s_len.cpu()[:, None, None]).expand(p64.shape)
    p_err = float(((p_d.cpu() - p_c).abs() / scale.float())[valid].max())
    check(p_err <= VARIANT_POWER_RTOL, f"variants: power {p_err}")
    well = valid & (p64 >= VARIANT_WELL * scale)
    s_err = (s_d.cpu() - s_c).abs()
    check(float(s_err[well].max()) <= VARIANT_TOL,
          f"variants: spectrogram {float(s_err[well].max())}")
    m_err = float((m_d.cpu() - m_c).abs().max())
    check(m_err <= VARIANT_TOL, f"variants: MFCC {m_err}")
    # the fp32 power and the unnormalized log power vs an fp64 chain, card
    # and CPU: the power is held (relative to each frame's largest); the
    # log's largest distance sits at the odd bin ~1e-8 of its frame's
    # largest power, where either fp32 product's last bits decide it, and
    # is printed
    import dataclasses

    p64_err = {k: float(((p.cpu().double() - p64).abs() / scale)[valid]
                        .max()) for k, p in (("card", p_d), ("cpu", p_c))}
    check(max(p64_err.values()) <= VARIANT_POWER_RTOL,
          f"variants: power vs fp64 {p64_err}")
    raw = dataclasses.replace(cfg, normalize="")
    with strict_fp32():
        r_d, _ = variants.spectrogram_features(sig, lens, cfg=raw,
                                               dft_matrix=dft)
    r_c, _ = variants.spectrogram_features(sig_c, lens_c, cfg=raw,
                                           dft_matrix=dft.cpu())
    ref = torch.log(p64 + raw.log_zero_guard_value).float()
    d_card = float((r_d.cpu() - ref).abs()[valid].max())
    d_cpu = float((r_c - ref).abs()[valid].max())
    with strict_fp32():
        ms = {"spectrogram": event_ms(lambda: spec(sig, lens), reps=10),
              "mfcc": event_ms(lambda: mfcc(sig, lens), reps=10),
              "log_mel": event_ms(lambda: tr._featurize(sig, lens),
                                  reps=10)}
        ms["kernel"], seen, _ = kernel_ms(lambda: tr._featurize(sig, lens),
                                          "logmel_kernel", reps=10)
    how = "CUPTI" if seen == 1 else \
        f"events: the trace saw {seen:g} of its 1 launch a call"
    print(f"phase 14e variants at B = 8 x 16.7 s: spectrogram "
          f"{tuple(s_d.shape)}, MFCC {tuple(m_d.shape)}; card vs CPU: power "
          f"max|d| / frame max {p_err:.3e} (tol {VARIANT_POWER_RTOL}), "
          f"spectrogram max|d| {float(s_err[well].max()):.3e} on bins >= "
          f"{VARIANT_WELL} of the frame max ({float(s_err[valid].max()):.3e}"
          f" on all), MFCC max|d| {m_err:.3e} (tol {VARIANT_TOL}); from an "
          f"fp64 chain: power / frame max card {p64_err['card']:.3e}, CPU "
          f"{p64_err['cpu']:.3e}, log power max|d| card {d_card:.3e}, CPU "
          f"{d_cpu:.3e}; ms (CUDA events): "
          f"spectrogram {ms['spectrogram']:.4f}, MFCC {ms['mfcc']:.4f}, the "
          f"fused featurizer's log-mel {ms['log_mel']:.4f} (its frontend "
          f"kernel alone {ms['kernel']:.4f}, {how})")


def phase14(np, torch, dev, signals, kernels):
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tr = kaldi_ctc_phase(np, torch, dev, signals, kernels, tmp)
        print(f"phase 14a done in {time.perf_counter() - t0:.1f} s")
        classify_phase(np, torch, dev, tr, kernels, tmp)
        print(f"phase 14b done in {time.perf_counter() - t0:.1f} s")
    las_phase(np, torch, dev, tr, signals, kernels)
    print(f"phase 14c done in {time.perf_counter() - t0:.1f} s")
    copy_task_phase(np, torch, dev)
    print(f"phase 14d done in {time.perf_counter() - t0:.1f} s")
    variants_phase(np, torch, dev, tr, signals)
    print(f"phase 14e done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: QuartzNet15x5 served at full width through the whole-block kernel


def qn15x5_jasper() -> list:
    """QuartzNet15x5's block list at its published widths (Kriman et al.
    2019, "QuartzNet", Table 1, https://arxiv.org/abs/1910.10261; NeMo's
    quartznet15x5.yaml), in the YAML's form: C1 k33 s2 at 256 channels,
    B1-B5 x 3 blocks of R = 5 (k 33 / 39 / 51 / 63 / 75 at 256 / 256 / 512 /
    512 / 512), C2 k87 dilation 2 at 512, C3 k1 at 1024."""
    def block(filters, kernel, repeat=1, stride=1, dilation=1,
              residual=False, separable=True):
        return {"filters": filters, "repeat": repeat, "kernel": [kernel],
                "stride": [stride], "dilation": [dilation], "dropout": 0.0,
                "residual": residual, "separable": separable}

    blocks = [block(256, 33, stride=2)]
    for filters, kernel in ((256, 33), (256, 39), (512, 51), (512, 63),
                            (512, 75)):
        blocks += [block(filters, kernel, repeat=5, residual=True)
                   for _ in range(3)]
    return blocks + [block(512, 87, dilation=2),
                     block(1024, 1, separable=False)]


def write_qn15x5_yaml(folder: str) -> str:
    """quartznet12x1_vi.yaml's sections (featurizer, data, Vietnamese
    labels) with QuartzNet15x5's encoder, written into `folder` (a test
    fixture: the repo ships no 15x5 config). Returns its path."""
    import yaml

    with open(CONFIG, encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    raw["model"] = "quartznet15x5_vi"
    raw["JasperEncoder"]["jasper"] = qn15x5_jasper()
    path = os.path.join(folder, "quartznet15x5_vi.yaml")
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(raw, f, allow_unicode=True, sort_keys=False)
    return path


def qn15x5_chain_numbers(np, torch, tr, signals, forwards, texts):
    """The yardstick end to end: the same greedy path with the R-launch
    chain (repeat_chain_cuda) patched in for the whole-block kernel here
    only (no route of the package takes the chain): 75 one-repeat launches
    a forward, the transcripts those of the whole-block route, audio-s/s
    and device busy time as path_numbers gives them."""
    from vietasr_tpu_torch.ops import repeat_block as rb

    real = rb.repeat_whole_block_cuda
    rb.repeat_whole_block_cuda = rb.repeat_chain_cuda
    try:
        tr.transcribe_batch(signals)                   # warm-up
        rb.fused_repeat_block.launches = real.launches = 0
        chain_texts = tr.transcribe_batch(signals)
        launches = {"repeat_block": rb.fused_repeat_block.launches,
                    "repeat_whole_block": real.launches}
        check(launches == {"repeat_block": 75 * forwards,
                           "repeat_whole_block": 0},
              f"15x5 greedy path with the chain: launches {launches}")
        same = sum(a == b for a, b in zip(chain_texts, texts))
        print(f"15x5 greedy path with the R-launch chain in place of the "
              f"whole-block kernel (yardstick, not a route): launches "
              f"{launches}, transcripts equal to the whole-block route's "
              f"{same}/{len(texts)}")
        audio_s, busy_ms, idle = path_numbers(
            np, torch, tr, signals, "15x5 greedy path, chain yardstick")
    finally:
        rb.repeat_whole_block_cuda = real
    return {"audio_s_per_s": audio_s, "busy_ms": busy_ms, "idle": idle}


def wide_block_check(torch, dev):
    """R = 5 blocks the whole-block plan cannot take (16 -> 512: 2 input
    channels a block; 512 -> 1024: 16 blocks of 64 columns) run per op on
    the default route, as JAX's default path runs them: no repeat-kernel
    launch, the log-probs of block_impl="plain" (both per op: the same
    operations, within 1e-4 for any reordering of a library's sums)."""
    from vietasr_tpu_torch.config import BlockConfig, EncoderConfig
    from vietasr_tpu_torch.models import quartznet as qn

    ecfg = EncoderConfig(feat_in=64, blocks=(
        BlockConfig(filters=16, kernel=11, stride=2, residual=False,
                    separable=True),
        BlockConfig(filters=512, repeat=5, kernel=9, residual=True,
                    separable=True),
        BlockConfig(filters=1024, repeat=5, kernel=33, residual=True,
                    separable=True),
        BlockConfig(filters=32, kernel=1, residual=False, separable=False)))
    v = qn.cast_matmul_weights(qn.fold_batchnorm(qn.init_quartznet(
        torch.Generator(device=dev).manual_seed(0), ecfg, 10, device=dev),
        ecfg), torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(4, 400, 64, device=dev, generator=g)
    lens = torch.tensor([400, 399, 123, 1], device=dev)
    reset_all_launches()
    lp, out_lens = qn.quartznet_apply(v, feats, lens, cfg=ecfg,
                                      compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = all_launches()
    want, _ = qn.quartznet_apply(v, feats, lens, cfg=ecfg,
                                 compute_dtype=torch.bfloat16,
                                 block_impl="plain")
    d = float((lp - want).abs().max())
    print(f"16 -> 512 and 512 -> 1024 R = 5 blocks on the default route: "
          f"launches {launches}, log-probs {tuple(lp.shape)}, max|d| vs "
          f"block_impl='plain' {d:.3e}")
    check(not any(launches.values()) and bool(torch.isfinite(lp).all())
          and d <= 1e-4, "wide R = 5 blocks did not run per op")


def qn15x5_phase(np, torch, dev, signals, lm_paths, kernels):
    """Phase 15: Transcriber on QuartzNet15x5 at full width (seeded
    init_quartznet, BN folded, bf16) over phase 5's 16 signals, greedy and
    device beam (W = 100, the word 3-gram): 1 frontend and 15 whole-block
    launches a forward, no one-repeat launch, each whole-block launch held
    to its plain version on its own inputs, the log-probs to the plain
    route's; the chain yardstick end to end (qn15x5_chain_numbers); the
    wide blocks per op (wide_block_check); the beam kernel's raw result
    bit for bit with the plain search."""
    import torch.nn.functional as F

    from vietasr_tpu_torch.models import quartznet as qn
    from vietasr_tpu_torch.models.quartznet import tree_leaves
    from vietasr_tpu_torch.ops.device_beam import (best_path_from_raw,
                                                   device_beam_search)
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    whole = next(k for k in kernels if k["name"] == "repeat_whole_block")
    with tempfile.TemporaryDirectory() as tmp:
        config = write_qn15x5_yaml(tmp)
        tr = Transcriber(config)
        ref = Transcriber(config, options=TranscriberOptions(
            fused_frontend="off", block_impl="plain"))
        trb = Transcriber(config, options=TranscriberOptions(
            decoder="device_beam", lm_path=lm_paths[3]))
    n_par = sum(p.numel() for p in tree_leaves(tr._float_variables["params"]))
    blocks = tr.cfg.encoder.blocks
    check(len(blocks) == 18 and sum(b.repeat == 5 for b in blocks) == 15,
          f"the 15x5 fixture has {len(blocks)} blocks")
    forwards = n_forwards(tr, signals)
    tr.transcribe_batch(signals)                       # warm-up
    calls, undo = record_repeat_calls(qn)
    try:
        reset_all_launches()
        texts = tr.transcribe_batch(signals)           # the main path
        launches = all_launches()
    finally:
        undo()
    print(f"QuartzNet15x5 greedy path ({n_par} parameters with BN folded, "
          f"bf16, init_quartznet seed 0): {len(signals)} signals, "
          f"{forwards} forwards, launches {launches}")
    check_launches(kernels, "qn15x5_greedy", launches,
                   {"log_mel_frontend": forwards,
                    "repeat_whole_block": 15 * forwards})
    whole["launches"] = launches["repeat_whole_block"]
    check(len(calls) == 15 * forwards and all(len(a[2]) == 5
                                              for a, _, _ in calls),
          f"{len(calls)} recorded repeat-block calls")
    worst = hold_repeat(calls, "qn15x5 greedy")
    print(f"each of the {len(calls)} whole-block launches vs its plain "
          f"version: worst max|d| / max|want| {worst:.3e} (bar "
          f"{REPEAT_TOL_REL})")
    del calls

    # the kernel route vs the plain route (plain frontend, plain blocks)
    worst_lp, agree = 0.0, []
    for sig in signals:
        lp, el = tr.log_probs(sig)
        lp_ref, el_ref = ref.log_probs(sig)
        check(lp.shape == lp_ref.shape and np.isfinite(lp).all()
              and np.array_equal(el, el_ref),
              "15x5 log-probs: shape, finiteness or lengths")
        check(np.allclose(np.exp(lp).sum(-1), 1.0, atol=1e-3),
              "15x5 log-probs do not normalise")
        worst_lp = max(worst_lp, float(np.abs(lp - lp_ref).max()))
        agree.append(agreement(lp, lp_ref))
    ref_texts = ref.transcribe_batch(signals)
    same = sum(a == b for a, b in zip(texts, ref_texts))
    print(f"15x5 kernel route vs plain route: max|d log p| {worst_lp:.4e} "
          f"(tol {E2E_LOGP_TOL}), frame argmax agreement min "
          f"{min(agree):.4f} mean {sum(agree) / len(agree):.4f}, transcripts "
          f"equal {same}/{len(texts)} (random weights)")
    check(worst_lp <= E2E_LOGP_TOL, f"15x5 kernel route vs plain route: "
          f"max|d log p| {worst_lp} > {E2E_LOGP_TOL}")
    del ref
    audio_s, busy_ms, idle = path_numbers(np, torch, tr, signals,
                                          "15x5 greedy path")
    whole["qn15x5_greedy"] = {"audio_s_per_s": audio_s, "busy_ms": busy_ms,
                              "idle": idle}
    whole["qn15x5_greedy_chain"] = qn15x5_chain_numbers(np, torch, tr,
                                                        signals, forwards,
                                                        texts)
    del tr
    wide_block_check(torch, dev)

    # device beam, W = 100, the word 3-gram: one beam launch a call
    check(trb._device_word_lm is not None, "the word LM was not sniffed")
    labels = trb.cfg.labels
    trb.transcribe_batch(signals)                      # warm-up
    batches = forward_batches(np, torch, trb, signals)
    calls, undo = record_repeat_calls(qn)
    try:
        reset_all_launches()
        btexts = trb.transcribe_batch(signals)
        launches = all_launches()
    finally:
        undo()
    print(f"QuartzNet15x5 device beam path (W={trb.opts.beam_width}, word "
          f"3-gram): launches {launches}")
    check_launches(kernels, "qn15x5_device_beam", launches,
                   {"log_mel_frontend": forwards,
                    "repeat_whole_block": 15 * forwards, "beam_search": 1})
    hold_repeat(calls, "qn15x5 device beam")
    del calls
    t_max = max(lp.shape[1] for _, lp, _ in batches)
    lp = torch.cat([F.pad(lp, (0, 0, 0, t_max - lp.shape[1]))
                    for _, lp, _ in batches])
    el = torch.cat([e for _, _, e in batches])
    order = [g for group, _, _ in batches for g in group]
    kw = dict(beam_width=trb.opts.beam_width, space=labels.index(" "),
              word_lm=trb._device_word_lm, wlm_probes=trb._device_wlm_probes,
              **BEAM_KW)
    raw_k = fused_beam_search(lp, el, blank=len(labels), return_raw=True,
                              **kw)
    raw_p = device_beam_search(lp, el, blank=len(labels), return_raw=True,
                               **kw)
    torch.cuda.synchronize()
    raw_equal = all(torch.equal(a, b) for a, b in zip(raw_k, raw_p))
    ids, n = best_path_from_raw(*raw_p, word_lm=kw["word_lm"],
                                alpha=BEAM_KW["alpha"], beta=BEAM_KW["beta"],
                                wlm_probes=kw["wlm_probes"])
    plain_texts = [None] * len(signals)
    for g, text in zip(order, render(labels, ids, n)):
        plain_texts[g] = text
    same = sum(a == b for a, b in zip(btexts, plain_texts))
    print(f"15x5 device beam: B={lp.shape[0]} T={t_max} raw state / "
          f"backpointers equal to the plain search {raw_equal}; transcripts "
          f"equal {same}/{len(btexts)}")
    check(raw_equal, "15x5 device beam: the kernel's raw result differs "
          "from the plain search")
    check(same == len(btexts), "15x5 device beam transcripts differ from "
          "the plain search's")
    audio_s, busy_ms, idle = path_numbers(np, torch, trb, signals,
                                          "15x5 device beam path")
    whole["qn15x5_device_beam"] = {"audio_s_per_s": audio_s,
                                   "busy_ms": busy_ms, "idle": idle}


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

    from vietasr_tpu_torch import native

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    native.build_native(force=True)
    print(f"build: the host beam tier's C++ library (g++) in "
          f"{time.perf_counter() - t1:.1f} s")
    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    dev = torch.device("cuda")
    front = frontend_phase(np, torch, dev)
    fast = frontend_fast_phase(np, torch, dev)
    print(f"phases 1-3b done at {time.perf_counter() - t0:.1f} s")
    kernels = [front, repeat_phase(np, torch, dev),
               repeat_whole_phase(np, torch, dev)]
    signals = end_to_end_phase(np, torch, dev, kernels)
    fast["launches"] = fast_int8_phase(np, torch, dev, signals)
    kernels.insert(1, fast)
    print(f"phases 4-5c done at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        lm_paths = train_word_lms(tmp)
        kernels.append({"name": "beam_search", "launches": 0})
        labels, anchor_lp, anchor_lens = beam_path_phase(
            np, torch, signals, lm_paths, kernels)
        kernels[-1].update(beam_phase(np, torch, dev, labels, anchor_lp,
                                      anchor_lens, lm_paths))
        host_beam_phase(np, torch, signals, lm_paths, tmp)
        print(f"phases 1-6b done at {time.perf_counter() - t0:.1f} s")
        longform_phase(np, torch, dev, lm_paths, kernels)
        print(f"phase 9 done at {time.perf_counter() - t0:.1f} s")
        streaming_phase(np, torch, dev, lm_paths, kernels)
        print(f"phase 10 done at {time.perf_counter() - t0:.1f} s")
        conformer_offline_phase(np, torch, dev, signals, lm_paths, kernels)
        conformer_streaming_phase(np, torch, dev, lm_paths, kernels)
        print(f"phase 11 done at {time.perf_counter() - t0:.1f} s")
        qn15x5_phase(np, torch, dev, signals, lm_paths, kernels)
    print(f"phase 15 done at {time.perf_counter() - t0:.1f} s")
    kernels += ctc_phase(np, torch, dev)
    print(f"phase 7 done at {time.perf_counter() - t0:.1f} s")
    train_phase(np, torch, dev, kernels)
    print(f"phase 8 done at {time.perf_counter() - t0:.1f} s")
    phase12(np, torch, dev, kernels)
    print(f"phase 12 done at {time.perf_counter() - t0:.1f} s")
    phase13(np, torch, dev, kernels)
    print(f"phase 13 done at {time.perf_counter() - t0:.1f} s")
    phase14(np, torch, dev, signals, kernels)
    print(f"phase 14 done at {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
