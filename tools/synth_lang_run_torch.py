"""Synthetic-language generalization study on vietasr_tpu_torch (the
PyTorch/CUDA port): the counterpart of tools/synth_lang_run.py.

The corpus is made from code alone: each label of the Vietnamese
inventory maps to a fixed formant signature (v2: log-spaced formant
pairs, chirp direction and a gated noise band, all of which survive the
±10 % speed perturbation), words are concatenations of their letters'
signatures, and utterances are word sequences with silence gaps.
Training composes FRESH word sequences at every read, with per-read
speed / gain / noise augmentation, through the port's real stack
(BucketBatcher, the log-mel frontend, QuartzNet or Conformer, CTC,
Novograd or AdamW + cosine, checkpoints). Evaluation scores 64 fixed
held-out word sequences that training never composes, offline through
the Transcriber and streaming through the online runtimes, plus 64
clean compositions from the training distribution (the convergence
check).

Given the same labels and seeds, the corpus (WAV bytes, manifests) and
the stream of training reads are the JAX tool's bit for bit
(tests/test_torch_synth_lang.py), so the BucketBatcher trains on the
batches the JAX runs trained on. The model's init and dropout draw from
a torch.Generator (`--seed`) and differ from JAX's by design.

Results go to artifacts/study/torch_synth_<tag>.json and the loss curve
to artifacts/study/torch_train_<tag>.jsonl, beside (never over) the JAX
runs' synth_<tag>.json / train_<tag>.jsonl; both are also printed.

Usage (on the GPU; `--device cpu` runs the plain PyTorch path):
    python tools/synth_lang_run_torch.py --phase corpus
    python tools/synth_lang_run_torch.py --phase train --tag qn_v2 \\
        --steps 2500
    python tools/synth_lang_run_torch.py --phase eval --tag qn_v2
A few steps on the CPU (`--max-steps` stops early; the schedule still
spans `--steps`):
    python tools/synth_lang_run_torch.py --device cpu --phase corpus \\
        --n-heldout 8
    python tools/synth_lang_run_torch.py --device cpu --phase train \\
        --tag cpu --batch-size 4 --max-steps 3
    python tools/synth_lang_run_torch.py --device cpu --phase eval \\
        --tag cpu --art-dir work/study_cpu
A resumed run trains from the newest checkpoint to the recipe's step
count (the JAX tool trains the recipe's epochs again after a resume).
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import wave

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QN_CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                         "quartznet12x1_vi.yaml")
ART_DIR = os.path.join(ROOT, "artifacts", "study")
SR = 16000
AUG = ("speed", "gain", "noise")
# the end-to-end gate of a bf16 kernel route (logp_gate, which
# chip_smoke.py applies too), measured from the fp32 forward on the same
# weights and signals: the kernel route's largest |d log p| from it may
# reach E2E_LOGP_TOL, or ROUTE_RATIO times the plain route's own largest
# where that is more. The two bf16 routes round at the same points and
# differ in fp32 summation order, which flips single bf16 roundings of
# block outputs that compound over the blocks, so neither is the truth:
# a kernel that is only another bf16 chain lies as far from fp32 as its
# plain version does, one with a fault lies farther
E2E_LOGP_TOL = 0.25
ROUTE_RATIO = 1.5

# vocabulary: real Vietnamese words (chars all inside the 91-label
# inventory), same corpus the bench word-LM uses
WORDS = sorted(set(" ".join([
    "xin chào các bạn", "bản tin thời sự hôm nay", "chào mừng quý vị",
    "tin tức trong ngày", "cảm ơn các bạn đã lắng nghe",
    "thời tiết hà nội hôm nay", "chúc các bạn một ngày tốt lành",
    "đây là đài tiếng nói việt nam", "tin thể thao quốc tế",
    "giá xăng dầu trong nước", "tình hình giao thông buổi sáng",
    "xin kính chào quý vị và các bạn", "bản tin cuối ngày",
    "chương trình ca nhạc theo yêu cầu", "dự báo thời tiết ngày mai",
]).split()))


def _shown(path):
    """A path as the records give it: relative to the repository root
    when it lies inside it."""
    full = os.path.abspath(path)
    return os.path.relpath(full, ROOT) if full.startswith(ROOT + os.sep) \
        else path


def _found(path):
    """A recorded path, found from the working directory or else from the
    repository root."""
    return path if os.path.isabs(path) or os.path.exists(path) \
        else os.path.join(ROOT, path)


# ---------------------------------------------------------------------------
# the corpus (pure numpy)


def _char_wave(ci: int, sr: int = SR) -> np.ndarray:
    """Formant-pair signature for label index `ci` (v1): two sinusoids on
    LINEAR (F1, F2) grids + a weak octave, 70-110 ms by a char hash. Kept
    for the study record: at the top of each grid the spacing is under the
    ±10 % speed perturbation, so chars alias under augmentation."""
    h = (ci * 2654435761) & 0xFFFFFFFF
    dur = 0.07 + 0.04 * ((h >> 8) % 7) / 6.0
    n = int(dur * sr)
    t = np.arange(n) / sr
    f1 = 280.0 + 62.0 * (ci % 9)
    f2 = 950.0 + 135.0 * ((ci // 9) % 13)
    env = np.minimum(np.minimum(t / 0.012, (dur - t) / 0.02), 1.0)
    x = (0.55 * np.sin(2 * np.pi * f1 * t)
         + 0.35 * np.sin(2 * np.pi * f2 * t)
         + 0.10 * np.sin(2 * np.pi * 2 * f1 * t))
    return (0.25 * x * np.clip(env, 0.0, 1.0)).astype(np.float32)


def _char_wave_v2(ci: int, sr: int = SR) -> np.ndarray:
    """Speed-robust broadband signature for label index `ci` (v2): f1, f2
    on log grids with ratio-1.35 spacing (disjoint under any two rates in
    [0.9, 1.1]), the f2 chirp's direction (down / flat / up) and a gated
    5.0-6.4 kHz noise band: 5 x 5 x 3 x 2 = 150 codes. Envelope and
    hash-varied duration as v1."""
    h = (ci * 2654435761) & 0xFFFFFFFF
    dur = 0.07 + 0.04 * ((h >> 8) % 7) / 6.0
    n = int(dur * sr)
    t = np.arange(n) / sr
    i1 = ci % 5
    i2 = (ci // 5) % 5
    chirp = (ci // 25) % 3 - 1
    noise_on = (ci // 75) % 2
    f1 = 300.0 * 1.35 ** i1                      # 300 .. 997 Hz
    f2 = 1200.0 * 1.35 ** i2                     # 1200 .. 3986 Hz
    env = np.clip(np.minimum(np.minimum(t / 0.012, (dur - t) / 0.02),
                             1.0), 0.0, 1.0)
    # instantaneous f2 frequency: f2 * (1 + 0.12 * chirp * t / dur)
    phase2 = 2 * np.pi * f2 * (t + 0.12 * chirp * t * t / (2 * dur))
    x = (0.45 * np.sin(2 * np.pi * f1 * t)
         + 0.35 * np.sin(phase2)
         + 0.10 * np.sin(2 * np.pi * 2 * f1 * t))
    if noise_on:
        rng = np.random.RandomState((ci * 7919 + 13) & 0x7FFFFFFF)
        spec = np.fft.rfft(rng.randn(n))
        freqs = np.fft.rfftfreq(n, 1.0 / sr)
        spec[(freqs < 5000.0) | (freqs > 6400.0)] = 0.0
        band = np.fft.irfft(spec, n)
        band /= max(float(np.sqrt(np.mean(band ** 2))), 1e-9)
        x = x + 0.18 * band
    return (0.25 * x * env).astype(np.float32)


def make_bank(labels, sig: str = "v2"):
    """word -> waveform for every vocabulary word."""
    wave_fn = {"v1": _char_wave, "v2": _char_wave_v2}[sig]
    lab_idx = {c: i for i, c in enumerate(labels)}
    bank = {}
    for w in WORDS:
        if any(c not in lab_idx for c in w):
            continue
        bank[w] = np.concatenate([wave_fn(lab_idx[c]) for c in w])
    return bank


def _min_samples(text: str) -> int:
    """Samples an utterance needs so that CTC can emit `text` after the
    model's 2x stride: a frame per char, one more per doubled char, 8 of
    slack, 4x over, at the 160-sample hop."""
    return (len(text) + sum(a == b for a, b in zip(text, text[1:]))
            + 8) * 4 * 160


class SynthDynamicDataset:
    """Fresh word-sequence composition per read, with per-read speed /
    gain / noise augmentation (the port's audio/augment.py). `exclude`
    holds the held-out word sequences, which are never composed. One
    RandomState drives budgets, compositions and augmentation, as in the
    JAX tool, so the reads in order are the JAX tool's bit for bit."""

    def __init__(self, bank, tokenizer, *, seed: int, size: int,
                 exclude=(), sample_rate: int = SR, aug=AUG):
        from vietasr_tpu_torch.audio.augment import (AudioAugmentor,
                                                     GainPerturbation,
                                                     SpeedPerturbation,
                                                     WhiteNoisePerturbation)
        from vietasr_tpu_torch.audio.manifest import ManifestEntry

        self.words = sorted(bank)
        self.bank = bank
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.exclude = set(exclude)
        self.rng = np.random.RandomState(seed)
        perturbations = []
        if "speed" in aug:
            perturbations.append((1.0, SpeedPerturbation(0.9, 1.1,
                                                         rng=self.rng)))
        if "gain" in aug:
            perturbations.append((0.7, GainPerturbation(-6, 6,
                                                        rng=self.rng)))
        if "noise" in aug:
            perturbations.append((0.7, WhiteNoisePerturbation(-60, -38,
                                                              rng=self.rng)))
        self.augment = AudioAugmentor(perturbations=perturbations,
                                      rng=self.rng)
        budgets = self.rng.uniform(2.0, 6.0, size=size)
        self.entries = [ManifestEntry("synthetic://lang", float(b), "dyn")
                        for b in budgets]
        self.num_dropped = 0

    def __len__(self):
        return len(self.entries)

    def max_token_len(self):
        return 160

    def compose(self, budget_samples: int, rng):
        while True:
            parts, words, used = [], [], 0
            text = ""
            while True:
                w = self.words[rng.randint(0, len(self.words))]
                seg = self.bank[w]
                gap = int(rng.randint(480, 1280))
                cand = (text + " " if text else "") + w
                need = _min_samples(cand)
                cand_len = used + (gap if parts else 0) + len(seg)
                if max(cand_len, need) * 1.12 > budget_samples:
                    if words:
                        break
                    continue
                if parts:
                    parts.append(np.zeros(gap, np.float32))
                    used += gap
                parts.append(seg)
                used += len(seg)
                words.append(w)
                text = cand
                if len(words) >= 8:
                    break
            if tuple(words) not in self.exclude:
                return np.concatenate(parts), text

    def __getitem__(self, i):
        budget = int(self.entries[i].duration * self.sample_rate)
        sig, text = self.compose(budget, self.rng)
        sig = self.augment(sig, self.sample_rate).astype(np.float32)
        need = _min_samples(text)
        if len(sig) < need:
            sig = np.concatenate([sig,
                                  np.zeros(need - len(sig), np.float32)])
        ids = self.tokenizer.encode(text)
        return sig, ids


def _write_wav(path, sig):
    pcm = np.clip(sig * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def heldout_sequences(bank, n, seed=123):
    """Fixed held-out word sequences (clean, no augmentation)."""
    words = sorted(bank)
    rng = np.random.RandomState(seed)
    out = []
    seen = set()
    while len(out) < n:
        k = rng.randint(3, 8)
        seq = tuple(words[rng.randint(0, len(words))] for _ in range(k))
        if seq in seen:
            continue
        seen.add(seq)
        out.append(seq)
    return out


def phase_corpus(work_dir, n_heldout, labels, sig="v2"):
    bank = make_bank(labels, sig)
    seqs = heldout_sequences(bank, n_heldout)
    d = os.path.join(work_dir, "heldout")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(7)
    path = os.path.join(work_dir, "heldout_manifest.json")
    with open(path, "w", encoding="utf-8") as f:
        for i, seq in enumerate(seqs):
            parts = []
            for w in seq:
                parts.append(bank[w])
                parts.append(np.zeros(rng.randint(480, 1280), np.float32))
            text = " ".join(seq)
            wave_arr = np.concatenate(parts[:-1])
            need = _min_samples(text)
            if len(wave_arr) < need:
                wave_arr = np.concatenate(
                    [wave_arr, np.zeros(need - len(wave_arr), np.float32)])
            wav = os.path.join(d, f"utt{i:04d}.wav")
            _write_wav(wav, wave_arr)
            f.write(json.dumps({"audio_filepath": wav,
                                "duration": round(len(wave_arr) / SR, 3),
                                "text": text}, ensure_ascii=False) + "\n")
    print(json.dumps({"manifest": path, "utts": len(seqs),
                      "vocab": len(bank), "signatures": sig}))


def _write_traindist(work_dir, bank, n, exclude):
    """n CLEAN utterances from the TRAIN distribution (fresh compositions,
    held-out sequences excluded, no augmentation): under dynamic
    composition their WER separates didn't-converge from
    didn't-generalize. Kept if already written."""
    from vietasr_tpu_torch.audio import CharTokenizer

    path = os.path.join(work_dir, "traindist_manifest.json")
    if os.path.exists(path):
        return path
    d = os.path.join(work_dir, "traindist")
    os.makedirs(d, exist_ok=True)
    tok = CharTokenizer([c for c in sorted({c for w in bank for c in w})])
    ds = SynthDynamicDataset(bank, tok, seed=999, size=n, exclude=exclude,
                             aug=())
    rng = np.random.RandomState(999)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            sig_arr, text = ds.compose(int(ds.entries[i].duration * SR),
                                       rng)
            wav = os.path.join(d, f"utt{i:04d}.wav")
            _write_wav(wav, sig_arr)
            f.write(json.dumps({"audio_filepath": wav,
                                "duration": round(len(sig_arr) / SR, 3),
                                "text": text}, ensure_ascii=False) + "\n")
    return path


# ---------------------------------------------------------------------------
# training


def study_config(config, *, dropout=None, normalize=None, num_blocks=None):
    """The model config with the study's overrides (a Conformer's dropout
    and depth, the featurizer's normalization)."""
    from vietasr_tpu_torch.config import load_config

    cfg = load_config(config)
    if dropout is not None and cfg.conformer is not None:
        cfg = dataclasses.replace(
            cfg, conformer=dataclasses.replace(cfg.conformer,
                                               dropout=dropout))
    if num_blocks is not None and cfg.conformer is not None:
        cfg = dataclasses.replace(
            cfg, conformer=dataclasses.replace(cfg.conformer,
                                               num_blocks=num_blocks))
    if normalize is not None:
        cfg = dataclasses.replace(
            cfg, featurizer=dataclasses.replace(cfg.featurizer,
                                                normalize=normalize))
    return cfg


def study_batcher(labels, batch_size, *, sig="v2", aug=AUG):
    """The training batcher of a recipe: batch_size x 64 reads an epoch,
    data seed 0, buckets up to 7 s sized for the speed perturbation's
    worst case."""
    from vietasr_tpu_torch.audio import BucketBatcher, CharTokenizer

    bank = make_bank(labels, sig)
    exclude = set(heldout_sequences(bank, 64))
    ds = SynthDynamicDataset(bank, CharTokenizer(labels), seed=0,
                             size=batch_size * 64, exclude=exclude, aug=aug)
    return BucketBatcher(ds, batch_size, max_duration=7.0,
                         bucket_margin=1.12)


class StepCap:
    """A batcher that stops after `steps` batches over all its epochs, so
    that a resumed or cut run ends at the step it names."""

    def __init__(self, batcher, steps: int):
        self.batcher, self.left = batcher, steps

    def __iter__(self):
        if self.left <= 0:
            return
        for batch in self.batcher:
            self.left -= 1
            yield batch
            if self.left <= 0:
                return


def kernel_launches() -> dict:
    """The port's kernel wrappers' launch counters (each counts one per
    launch of its kernel, on the GPU only)."""
    from vietasr_tpu_torch.frontend import cuda_frontend as cf
    from vietasr_tpu_torch.ops import fused_ctc as fc
    from vietasr_tpu_torch.ops.fused_beam import fused_beam_search
    from vietasr_tpu_torch.ops.repeat_block import (fused_repeat_block,
                                                    repeat_whole_block_cuda)

    return {"log_mel_frontend": cf.fused_log_mel_features.launches,
            "frontend_fast": cf.log_mel_tiles_fast_cuda.launches,
            "repeat_block": fused_repeat_block.launches,
            "repeat_whole_block": repeat_whole_block_cuda.launches,
            "beam_search": fused_beam_search.launches,
            "ctc_alpha": fc.fused_ctc_alpha.launches,
            "ctc_beta": fc.fused_ctc_beta.launches}


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_train(work_dir, config, tag, steps, batch_size, lr,
                optimizer="novograd", warmup=None, dropout=None,
                aug=AUG, sig="v2", normalize=None, num_blocks=None, *,
                device=None, seed=0, max_steps=None, log_every=50,
                compute_dtype="bfloat16"):
    """Train a recipe into work_dir/run_<tag>, resuming from its newest
    checkpoint. Stops at the recipe's last step or at `max_steps`,
    whichever comes first. Returns the run's summary (also written to
    run_<tag>/train_summary.json)."""
    import torch

    from vietasr_tpu_torch.config import save_config
    from vietasr_tpu_torch.models import model_init
    from vietasr_tpu_torch.train import (CheckpointManager, TrainState,
                                         Trainer, make_optimizer,
                                         make_schedule)
    from vietasr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = study_config(config, dropout=dropout, normalize=normalize,
                       num_blocks=num_blocks)
    run_dir = os.path.join(work_dir, f"run_{tag}")
    os.makedirs(run_dir, exist_ok=True)
    if dropout is not None or normalize is not None \
            or num_blocks is not None:
        # emit the patched config so eval/serving read the SAME model
        config = os.path.join(run_dir, "config.yaml")
        save_config(cfg, config)
    with open(os.path.join(run_dir, "meta.json"), "w") as f:
        json.dump({"config": _shown(config), "tag": tag, "signatures": sig,
                   "aug": list(aug), "steps": steps, "lr": lr,
                   "optimizer": optimizer, "warmup": warmup,
                   "dropout": dropout, "normalize": normalize,
                   "num_blocks": num_blocks,
                   "batch_size": batch_size, "init_seed": seed}, f)
    batcher = study_batcher(cfg.labels, batch_size, sig=sig, aug=aug)
    steps_per_epoch = max(batcher.steps_per_epoch(), 1)
    epochs = max(steps // steps_per_epoch, 1)
    total = epochs * steps_per_epoch
    schedule = make_schedule("CosineAnnealing", lr, total,
                             warmup_steps=warmup or steps // 20)
    opt = make_optimizer(optimizer, schedule, weight_decay=0.001,
                         grad_clip_norm=5.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = TrainState.create(model_init(gen, cfg, device=dev), opt)
    cm = CheckpointManager(run_dir, keep=4, device=dev)
    if cm.restore(state) is not None:
        print(f"resumed from step {int(state.step)}")
    start = int(state.step)
    last = total if max_steps is None else min(total, max_steps)
    # SpecAugment off: random word sequences have no linguistic context
    # to recover a masked word from
    trainer = Trainer(cfg, lr_schedule=schedule, log_every=log_every,
                      checkpoint_manager=cm,
                      checkpoint_every=max(steps // 4, 1),
                      compute_dtype=compute_dtype, use_specaug=False,
                      seed=seed, device=dev)
    log_path = os.path.join(run_dir, "train_log.jsonl")

    def _log_metric(tr, m):
        line = json.dumps(m, ensure_ascii=False)
        print(line, flush=True)
        with open(log_path, "a", encoding="utf-8") as lf:
            lf.write(line + "\n")

    trainer.callbacks.append(_log_metric)
    before = kernel_launches()
    _sync(dev)
    t0 = time.perf_counter()
    state = trainer.fit(state, StepCap(batcher, last - start),
                        num_epochs=epochs)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _launches_since(before)
    cm.save(state)
    end = int(state.step)
    taken = end - start
    summary = {"start_step": start, "end_step": end, "recipe_steps": total,
               "steps_per_epoch": steps_per_epoch, "epochs": epochs,
               "skipped_steps": int(state.skipped_steps),
               "wall_s": wall,
               "step_ms": 1e3 * wall / taken if taken else None,
               "launches": launches}
    with open(os.path.join(run_dir, "train_summary.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps({"train_summary": summary}))
    print(f"done at step {end}")
    return summary


# ---------------------------------------------------------------------------
# evaluation


def _greedy_text(lp, labels):
    import torch

    from vietasr_tpu_torch.ops.greedy import (collapse_batch, greedy_decode,
                                              ids_to_text)

    preds, keep = greedy_decode(torch.from_numpy(np.asarray(lp))[None],
                                torch.tensor([lp.shape[0]]),
                                blank=len(labels))
    ids = collapse_batch(preds, keep)[0]
    return ids_to_text(ids, labels).strip()


def restore_variables(run_dir, device):
    from vietasr_tpu_torch.train import CheckpointManager

    variables = CheckpointManager(run_dir, device=device).restore_variables()
    if variables is None:
        raise FileNotFoundError(f"no checkpoints in {run_dir}")
    return variables


def load_transcriber(config, run_dir, *, device=None, **options):
    """Transcriber from a work-dir checkpoint (CheckpointManager layout);
    fp32 unless `options` say otherwise (the JAX tool's loader)."""
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    options.setdefault("compute_dtype", None)
    return Transcriber(config, variables=restore_variables(run_dir, device),
                       options=TranscriberOptions(**options), device=device)


def _streaming_decode(cfg, run_dir, sigs, *, device=None):
    """Per-utterance transcripts through the REAL-TIME runtime for the
    checkpoint: chunked-causal attention for streaming Conformer configs
    (None for a full-context one), the ring-buffer streamer (causal
    per-frame norm) for QuartzNet."""
    from vietasr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    variables = restore_variables(run_dir, dev)
    if cfg.architecture == "conformer":
        if not getattr(cfg.conformer, "chunk_size", 0):
            return None
        from vietasr_tpu_torch.streaming_conformer import \
            ConformerOnlineTranscriber

        ot = ConformerOnlineTranscriber(cfg, variables, device=dev)
        cs = ot.required_chunk_samples
    else:
        from vietasr_tpu_torch.models.quartznet import fold_batchnorm
        from vietasr_tpu_torch.streaming_online import OnlineTranscriber

        ot = OnlineTranscriber(cfg, fold_batchnorm(variables, cfg.encoder),
                               causal_norm=True, device=dev)
        cs = 3200                            # 0.2 s, multiple of 2*hop
    hyps = []
    for sig in sigs:
        pad = (-len(sig)) % cs
        padded = np.concatenate([sig, np.zeros(pad, np.float32)])
        # true_samples: the utterance's end runs as the tail step, the
        # lookahead drains on zero features (offline padding semantics)
        lp = ot.stream([padded[i:i + cs]
                        for i in range(0, len(padded), cs)],
                       true_samples=len(sig))
        hyps.append(_greedy_text(lp, cfg.labels))
    return hyps


def read_split(manifest):
    """(refs, signals) of a manifest's utterances."""
    from vietasr_tpu_torch.audio.io import read_audio

    with open(manifest, encoding="utf-8") as f:
        entries = [json.loads(l) for l in f]
    return ([e["text"] for e in entries],
            [read_audio(e["audio_filepath"], target_sr=SR)[0]
             for e in entries])


def bf16_step(x) -> np.ndarray:
    """The bf16 step (ulp) at each value of x: 2^(e - 7) for |x| in
    [2^e, 2^(e+1)), the smallest normal's below that."""
    x = np.abs(np.asarray(x, np.float32))
    _, e = np.frexp(np.maximum(x, np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def _log_z(x):
    """log sum exp over the last axis, in fp64."""
    x = np.asarray(x, np.float64)
    m = x.max(-1, keepdims=True)
    return (m + np.log(np.exp(x - m).sum(-1, keepdims=True)))[..., 0]


def logp_gate(items, tol: float = E2E_LOGP_TOL, keep: int = 64,
              ratio: float = ROUTE_RATIO) -> dict:
    """The end-to-end gate of a bf16 kernel route. `items` yields, per
    item, arrays of one shape (..., classes): (lp, lp_ref, logits,
    logits_ref) of the kernel route and the plain route, then (lp_fp32,
    logits_fp32) of the fp32 forward on the same weights and signals, and
    optionally (lp_fp32_ref, logits_fp32_ref) where the plain side has an
    fp32 forward of its own (another package). The logits are the head's
    output the log-probs were taken from (with_logits).

    The verdict, over every entry (a class at a frame) of every item:
    d_k = max |lp - lp_fp32| <= max(tol, ratio * d_p), d_p = max |lp_ref -
    lp_fp32_ref|. Items of four arrays (two loads of one route, no fp32
    forward) are held by the kernel-vs-plain rule alone: every |lp -
    lp_ref| <= tol. One call takes items of one kind.

    Either way it records the kernel route against the plain route: the
    largest |d log p|, the worst entry and each entry past `tol` (the
    `keep` largest, and their count) with both routes' logits, the bf16
    step (ulp) at the larger magnitude of the two, their difference in
    those steps and the row's d log Z (Z the sum of exp(logit), so d log p
    = d logit - d log Z), over every row the largest |d log Z| and logit,
    and that rule's verdict (`kernel_vs_plain_ok`); with an fp32 forward
    also d_k, d_p, their ratio, the bar and the entries where each route
    lies farthest from fp32. Returns ok, the reason it failed, and those
    numbers."""
    worst, past, kinds = None, [], set()
    far = {"kernel": None, "plain": None}
    out = {"tol": tol, "max_abs_dlogp": 0.0, "max_row_dlogz": 0.0,
           "max_abs_logit": 0.0, "past_tol": 0, "max_steps_past_tol": 0.0,
           "kernel_vs_plain_failed": None}

    def entry(item, r, c):
        a, b = float(lg[r, c]), float(lg_ref[r, c])
        step = float(bf16_step(max(abs(a), abs(b))))
        e = {"item": item, "row": int(r), "cls": int(c),
             "dlogp": float(d[r, c]), "logp": float(lp[r, c]),
             "logp_ref": float(lp_ref[r, c]), "logit": a,
             "logit_ref": b, "ulp": step, "steps": abs(a - b) / step,
             "row_dlogz": float(dz[r])}
        if fp32:
            e.update(logp_fp32=float(lp32[r, c]),
                     logit_fp32=float(lg32[r, c]))
            if lp32_ref is not lp32:
                e.update(logp_fp32_ref=float(lp32_ref[r, c]),
                         logit_fp32_ref=float(lg32_ref[r, c]))
        return e

    def from_fp32(item, route, a, a32, lga, lg32a):
        dd = np.nan_to_num(np.abs(a - a32), nan=np.inf)
        r, c = np.unravel_index(np.argmax(dd), dd.shape)
        if far[route] is None or dd[r, c] > far[route]["dlogp"]:
            far[route] = {
                "item": item, "row": int(r), "cls": int(c),
                "dlogp": float(dd[r, c]), "logp": float(a[r, c]),
                "logp_fp32": float(a32[r, c]), "logit": float(lga[r, c]),
                "logit_fp32": float(lg32a[r, c]),
                "row_dlogz": float(abs(_log_z(lga[r]) - _log_z(lg32a[r])))}

    for item, arrays in enumerate(items):
        arrs = [np.asarray(a.float().cpu() if hasattr(a, "float") else a,
                           np.float32) for a in arrays]
        if len(arrs) not in (4, 6, 8) or len({a.shape for a in arrs}) != 1:
            raise ValueError(f"logp_gate: {len(arrs)} arrays of shapes "
                             f"{[a.shape for a in arrs]}")
        kinds.add(len(arrs) > 4)
        if len(kinds) > 1:
            raise ValueError("logp_gate: items with and without an fp32 "
                             "forward in one call")
        arrs = [a.reshape(-1, a.shape[-1]) for a in arrs]
        lp, lp_ref, lg, lg_ref = arrs[:4]
        fp32 = len(arrs) > 4
        lp32 = lg32 = lp32_ref = lg32_ref = None
        if fp32:
            lp32, lg32 = arrs[4:6]
            lp32_ref, lg32_ref = arrs[6:8] if len(arrs) == 8 \
                else (lp32, lg32)
        d = np.nan_to_num(np.abs(lp - lp_ref), nan=np.inf)
        dz = np.nan_to_num(np.abs(_log_z(lg) - _log_z(lg_ref)), nan=np.inf)
        if not d.size:
            continue
        out["max_abs_logit"] = max(out["max_abs_logit"], float(
            np.abs(np.concatenate([lg, lg_ref])).max()))
        out["max_row_dlogz"] = max(out["max_row_dlogz"], float(dz.max()))
        r, c = np.unravel_index(np.argmax(d), d.shape)
        if worst is None or d[r, c] > worst["dlogp"]:
            worst = entry(item, r, c)
        out["max_abs_dlogp"] = max(out["max_abs_dlogp"], float(d[r, c]))
        for r, c in zip(*np.nonzero(d > tol)):
            e = entry(item, r, c)
            out["past_tol"] += 1
            out["max_steps_past_tol"] = max(out["max_steps_past_tol"],
                                            e["steps"])
            past.append(e)
            if out["kernel_vs_plain_failed"] is None:
                out["kernel_vs_plain_failed"] = (
                    f"|d log p| {e['dlogp']} > {tol} at item {item}, row "
                    f"{r}, class {c} (logits {e['logit']} / "
                    f"{e['logit_ref']}, {e['steps']:g} bf16 steps; the "
                    f"row's |d log Z| {e['row_dlogz']:.4g})")
        past = sorted(past, key=lambda e: -e["dlogp"])[:keep]
        if fp32:
            from_fp32(item, "kernel", lp, lp32, lg, lg32)
            from_fp32(item, "plain", lp_ref, lp32_ref, lg_ref, lg32_ref)
    out.update(kernel_vs_plain_ok=out["kernel_vs_plain_failed"] is None,
               worst=worst, entries=past)
    if kinds == {True}:
        d_k, d_p = far["kernel"]["dlogp"], far["plain"]["dlogp"]
        bar = max(tol, ratio * d_p)
        w = far["kernel"]
        out.update(rule="fp32", ratio=ratio, d_k=d_k, d_p=d_p,
                   d_ratio=d_k / d_p if d_p else None, bar=bar,
                   worst_kernel=w, worst_plain=far["plain"],
                   failed=None if d_k <= bar else (
                       f"the kernel route's |d log p| from fp32 {d_k} > "
                       f"{bar} = max({tol}, {ratio} x the plain route's "
                       f"{d_p}) at item {w['item']}, row {w['row']}, class "
                       f"{w['cls']} (log p {w['logp']} / fp32 "
                       f"{w['logp_fp32']}, logits {w['logit']} / "
                       f"{w['logit_fp32']})"))
    else:
        out.update(rule="kernel_vs_plain",
                   failed=out["kernel_vs_plain_failed"])
    out["ok"] = out["failed"] is None
    return out


def gate_line(g: dict) -> str:
    """One line of a logp_gate result: with an fp32 forward d_k, d_p, their
    ratio and the bar first; then the kernel route against the plain
    route: the worst entry with its logits, the bf16 step there and the
    steps they moved, the rows' d log Z, the entries past the tolerance
    and that rule's verdict."""
    w = g["worst"] or {}
    head = ""
    if g["rule"] == "fp32":
        ratio = "n/a" if g["d_ratio"] is None else f"{g['d_ratio']:.4g}"
        head = (f"from fp32: d_k {g['d_k']:.4e}, d_p {g['d_p']:.4e}, "
                f"d_k / d_p {ratio}, bar max({g['tol']}, {g['ratio']} d_p)"
                f" = {g['bar']:.4e}; kernel vs plain: ")
    tail = "" if g["kernel_vs_plain_ok"] or g["rule"] != "fp32" \
        else "; past the kernel-vs-plain rule"
    return (head + f"max|d log p| {g['max_abs_dlogp']:.4e} (tol {g['tol']})"
            f" at logits {w.get('logit', 0.0):.6g} / "
            f"{w.get('logit_ref', 0.0):.6g} (bf16 ulp "
            f"{w.get('ulp', 0.0):.6g}: {w.get('steps', 0.0):.3g} steps; "
            f"the row's |d log Z| {w.get('row_dlogz', 0.0):.4e}); "
            f"{g['past_tol']} entries past {g['tol']} (most steps "
            f"{g['max_steps_past_tol']:.3g}); max|d log Z| "
            f"{g['max_row_dlogz']:.4e}; max|logit| {g['max_abs_logit']:.6g}"
            + tail + ("" if g["ok"] else f"; FAILED: {g['failed']}"))


def with_logits(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the logits of its last forward, on the host),
    read as the input of the last torch.log_softmax call inside fn: a
    forward's one call takes its head's output (the 1x1 product plus its
    bias: the logits, fp32 on QuartzNet, whose 1x1 products accumulate and
    return fp32, and the Conformer's bf16 ones cast to fp32, which is
    exact). The models are left as they are: a pw_fn of the check's own
    would turn the repeat kernel off, and a wrapper of the 1x1 product
    would see the logits before the bias."""
    import torch

    seen, log_softmax = [], torch.log_softmax

    def recorded(x, *a, **k):
        seen.append(x)
        return log_softmax(x, *a, **k)

    torch.log_softmax = recorded
    try:
        out = fn(*args, **kwargs)
    finally:
        torch.log_softmax = log_softmax
    if not seen:
        raise RuntimeError("with_logits: the call ran no log_softmax")
    return out, seen[-1].detach().float().cpu().numpy()


def tf32_flags() -> dict:
    """The torch.backends TF32 flags in force (cuBLAS matmuls, cuDNN)."""
    import torch

    return {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}


ROUTES = ("kernel", "plain", "fp32")
ROUTE_PAIRS = (("kernel", "plain"), ("kernel", "fp32"), ("plain", "fp32"))


def route_transcribers(config, variables, *, device=None) -> dict:
    """The three routes on one set of weights: the bf16 kernel route (the
    default Transcriber: the frontend kernel and the fused repeat blocks),
    the bf16 plain route (fused_frontend="off", block_impl="plain": the
    kernels' plain versions, at the same rounding points) and the fp32
    forward through no kernel (compute_dtype=None, the plain frontend and
    blocks), which route_forward runs under strict_fp32."""
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    plain = dict(fused_frontend="off", block_impl="plain")
    return {"kernel": Transcriber(config, variables=variables,
                                  device=device),
            "plain": Transcriber(config, variables=variables, device=device,
                                 options=TranscriberOptions(**plain)),
            "fp32": Transcriber(config, variables=variables, device=device,
                                options=TranscriberOptions(
                                    compute_dtype=None, **plain))}


def route_forward(t, sig, blocks=None):
    """One forward of Transcriber `t` on one signal: ((lp, enc_lens),
    logits) as with_logits gives them; an fp32 Transcriber's under
    strict_fp32, so that it is IEEE fp32 whatever the TF32 flags say. With
    a list `blocks`, each encoder block's output and lengths are appended
    to it as host arrays ((B, T_i, C_i) fp32, (B,)), read by wrapping
    models.quartznet._apply_block for this one call (a pw_fn of the
    check's own would turn the repeat kernel off)."""
    import contextlib

    from vietasr_tpu_torch.models import quartznet as qn
    from vietasr_tpu_torch.utils.device import strict_fp32

    apply_block = qn._apply_block

    def recorded(*args, **kwargs):
        out = apply_block(*args, **kwargs)
        blocks.append((out[0][-1].float().cpu().numpy(),
                       out[1].cpu().numpy()))
        return out

    if blocks is not None:
        qn._apply_block = recorded
    try:
        with strict_fp32() if t.compute_dtype is None \
                else contextlib.nullcontext():
            return with_logits(t.log_probs, sig)
    finally:
        qn._apply_block = apply_block


def _head_record(item, r, c, x, lg, lp, w):
    """The head at one entry (frame r, class c): its input (the last
    block's output at r) in both bf16 routes, the column w[:, c] and what
    each route's logit and log p do against the fp32 forward's."""
    xk, xp, xf = (x[n][r].astype(np.float64) for n in ROUTES)
    wc = w[:, c].astype(np.float64)
    dx = xk - xp
    steps = np.abs(dx) / bf16_step(np.maximum(np.abs(xk), np.abs(xp)))
    differ = np.nonzero(dx)[0]
    part = np.abs(wc) * np.abs(dx)
    top = differ[np.argsort(-part[differ], kind="stable")][:8]

    def vs_fp32(n):
        return {"logit": float(lg[n][r, c]), "logp": float(lp[n][r, c]),
                "dlogit_fp32": float(lg[n][r, c] - lg["fp32"][r, c]),
                "dlogp_fp32": float(lp[n][r, c] - lp["fp32"][r, c]),
                "dlogz_fp32": float(_log_z(lg[n][r]) - _log_z(lg["fp32"][r])),
                "bound_fp32": float(np.abs(wc) @ np.abs(x[n][r] - xf))}

    return {"item": item, "row": int(r), "cls": int(c),
            "dlogp": float(abs(lp["kernel"][r, c] - lp["plain"][r, c])),
            "channels": int(xk.size), "channels_differ": int(differ.size),
            "differ_by_steps": {"1": int((steps[differ] <= 1).sum()),
                                "2": int(((steps > 1) & (steps <= 2)).sum()),
                                "more": int((steps > 2).sum())},
            "most_steps": float(steps.max()) if differ.size else 0.0,
            "top_channels": [{"ch": int(k), "kernel": float(xk[k]),
                              "plain": float(xp[k]), "fp32": float(xf[k]),
                              "steps": float(steps[k]), "w": float(wc[k])}
                             for k in top],
            "w_l1": float(np.abs(wc).sum()),
            "w_l2": float(np.sqrt((wc * wc).sum())),
            "bound": float(part.sum()),
            "dlogit": float(lg["kernel"][r, c] - lg["plain"][r, c]),
            "dlogz": float(_log_z(lg["kernel"][r]) - _log_z(lg["plain"][r])),
            "kernel": vs_fp32("kernel"), "plain": vs_fp32("plain"),
            "fp32": {"logit": float(lg["fp32"][r, c]),
                     "logp": float(lp["fp32"][r, c])}}


def route_divergence(variables, config, sigs, *, device=None, routes=None,
                     keep: int = 16) -> dict:
    """Where the bf16 kernel route and the bf16 plain route part, from
    each other and from the fp32 forward, on the same weights and signals:
    one forward a signal in each route of `routes` (route_transcribers of
    `variables` unless given). Returns
    - `gate`: logp_gate over the signals (kernel, plain, fp32);
    - `blocks`: per encoder block, over the rows inside each signal's
      length, for each pair of routes the largest |d|, the share of
      elements that differ and the largest |d| in bf16 steps of the larger
      value; for each bf16 route against fp32 also its largest and mean
      |d| over the fp32 block output's RMS (`rel_max`, `rel_mean`);
    - `first_block_past_one_step`: the first block whose kernel-route and
      plain-route outputs differ by more than one bf16 step (None if none);
    - `head`: at the worst kernel-vs-plain entry and each past
      E2E_LOGP_TOL (the `keep` largest), the head's input in both bf16
      routes (the channels that differ and by how many bf16 steps), the
      head column's L1 and L2 norms, the bound sum_k |w_kc| |dx_k| beside
      the measured d logit, d log Z, and each route's logit and log p
      against the fp32 forward's (_head_record);
    - `tf32`: the TF32 flags the bf16 routes ran under (the fp32 forward
      runs under strict_fp32)."""
    routes = routes or route_transcribers(config, variables, device=device)
    flags = tf32_flags()
    w = routes["fp32"].variables["params"]["decoder"]["w"]
    w = w.float().cpu().numpy()
    items, heads, acc = [], [], []
    for item, sig in enumerate(sigs):
        lp, lg, x = {}, {}, {}
        for n in ROUTES:
            blocks = []
            (lp_n, el), lg_n = route_forward(routes[n], sig, blocks)
            if n == "kernel":
                el_k = el
            elif lp_n.shape != lp["kernel"].shape \
                    or not np.array_equal(el, el_k):
                raise RuntimeError(f"route_divergence: the {n} route's "
                                   "log-prob shape or lengths differ from "
                                   "the kernel route's")
            lp[n], lg[n], x[n] = lp_n, lg_n, blocks
        items.append((lp["kernel"], lp["plain"], lg["kernel"], lg["plain"],
                      lp["fp32"], lg["fp32"]))
        if not acc:
            acc = [{"rows": 0, "n": 0, "sumsq": 0.0,
                    **{f"{a}_vs_{b}": {"max_abs": 0.0, "differ": 0,
                                       "max_steps": 0.0, "sum_abs": 0.0}
                       for a, b in ROUTE_PAIRS}}
                   for _ in x["fp32"]]
        for i, a in enumerate(acc):
            rows = int(x["fp32"][i][1][0])
            v = {n: x[n][i][0][0, :rows].astype(np.float64) for n in ROUTES}
            a["rows"] += rows
            a["channels"] = v["fp32"].shape[-1]
            a["n"] += v["fp32"].size
            a["sumsq"] += float((v["fp32"] ** 2).sum())
            for p, q in ROUTE_PAIRS:
                s = a[f"{p}_vs_{q}"]
                d = np.abs(v[p] - v[q])
                if not d.size:
                    continue
                step = bf16_step(np.maximum(np.abs(v[p]), np.abs(v[q])))
                s["max_abs"] = max(s["max_abs"], float(d.max()))
                s["differ"] += int((d > 0).sum())
                s["max_steps"] = max(s["max_steps"], float((d / step).max()))
                s["sum_abs"] += float(d.sum())
        last = {n: x[n][-1][0][0] for n in ROUTES}
        lp1 = {n: a[0] for n, a in lp.items()}
        lg1 = {n: a[0] for n, a in lg.items()}
        d = np.abs(lp1["kernel"] - lp1["plain"])
        picks = {np.unravel_index(np.argmax(d), d.shape)}
        picks |= set(zip(*np.nonzero(d > E2E_LOGP_TOL)))
        heads += [_head_record(item, r, c, last, lg1, lp1, w)
                  for r, c in sorted(picks)]
    blocks_out = []
    for i, a in enumerate(acc):
        rms = float(np.sqrt(a["sumsq"] / a["n"])) if a["n"] else 0.0
        rec = {"block": i, "rows": a["rows"], "channels": a["channels"],
               "rms_fp32": rms}
        for p, q in ROUTE_PAIRS:
            s = a[f"{p}_vs_{q}"]
            rec[f"{p}_vs_{q}"] = {
                "max_abs": s["max_abs"],
                "share_differ": s["differ"] / a["n"] if a["n"] else 0.0,
                "max_steps": s["max_steps"]}
            if q == "fp32":
                rec[f"{p}_vs_{q}"].update(
                    rel_max=s["max_abs"] / rms if rms else None,
                    rel_mean=s["sum_abs"] / a["n"] / rms if rms else None)
        blocks_out.append(rec)
    heads.sort(key=lambda h: -h["dlogp"])
    past = [h for h in heads if h["dlogp"] > E2E_LOGP_TOL][:keep]
    return {"gate": logp_gate(items), "tf32": flags,
            "blocks": blocks_out,
            "first_block_past_one_step": next(
                (b["block"] for b in blocks_out
                 if b["kernel_vs_plain"]["max_steps"] > 1), None),
            "head": past or heads[:1]}


def block_line(b: dict) -> str:
    """One line of a route_divergence block record."""
    kp, kf, pf = (b[f"{p}_vs_{q}"] for p, q in ROUTE_PAIRS)
    return (f"block {b['block']:2d} ({b['channels']} ch, rms "
            f"{b['rms_fp32']:.4g}): kernel vs plain max|d| "
            f"{kp['max_abs']:.4g} ({kp['max_steps']:.3g} bf16 steps, "
            f"{100 * kp['share_differ']:.3g} % differ); from fp32, max / "
            f"mean |d| over rms: kernel {kf['rel_max']:.4g} / "
            f"{kf['rel_mean']:.4g}, plain {pf['rel_max']:.4g} / "
            f"{pf['rel_mean']:.4g}")


def kernel_route_check(config, run_dir, sigs, *, device=None):
    """The repeat kernel's route (the default bf16 Transcriber: the
    frontend kernel and fused repeat blocks) against the plain route
    (fused_frontend="off", block_impl="plain") and the fp32 forward on the
    same card and signals: transcripts of each bf16 route, the transcripts
    that agree, each bf16 route's kernel launches, and route_divergence
    (logp_gate over every frame and class, the block profile, the
    head)."""
    variables = restore_variables(run_dir, device)
    routes = route_transcribers(config, variables, device=device)
    before = kernel_launches()
    hyps = [h.strip() for h in routes["kernel"].transcribe_batch(sigs)]
    launches = _launches_since(before)
    before = kernel_launches()
    plain_hyps = [h.strip() for h in routes["plain"].transcribe_batch(sigs)]
    plain_launches = _launches_since(before)
    div = route_divergence(variables, config, sigs, device=device,
                           routes=routes)
    return {"hyps": hyps, "plain_hyps": plain_hyps,
            "equal": sum(a == b for a, b in zip(hyps, plain_hyps)),
            "launches": launches, "plain_launches": plain_launches, **div}


def device_line(device):
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_eval(work_dir, config, tag, sig="v2", *, device=None,
               art_dir=ART_DIR):
    """Held-out and train-distribution WER / CER, offline (fp32
    Transcriber) and streaming; on a QuartzNet also the repeat kernel's
    route against the plain route and the fp32 forward
    (kernel_route_check): logp_gate's numbers (d_k, d_p, their ratio and
    bar; the entries past E2E_LOGP_TOL kernel vs plain, with their logits,
    bf16 steps and rows' d log Z), the TF32 flags, the block profile and
    the head's records go under kernel_route for both splits; it raises,
    once the result is written, when the held-out split fails the gate
    (the train-distribution split's verdict is recorded). Writes
    torch_synth_<tag>.json into work_dir and art_dir, and the loss curve
    as art_dir/torch_train_<tag>.jsonl; returns the result."""
    from vietasr_tpu_torch.train import CheckpointManager
    from vietasr_tpu_torch.train.metrics import word_error_rate
    from vietasr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    run_dir = os.path.join(work_dir, f"run_{tag}")
    meta = {}
    meta_path = os.path.join(run_dir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        config = _found(meta.get("config", config))
        sig = meta.get("signatures", sig)
    cfg = study_config(config)
    meta["steps_reached"] = CheckpointManager(
        run_dir, device=dev).list_steps()[-1]

    bank = make_bank(cfg.labels, sig)
    exclude = set(heldout_sequences(bank, 64))
    traindist_manifest = _write_traindist(work_dir, bank, 64, exclude)

    out = {"tag": tag, "config": _shown(config), "signatures": sig,
           "meta": meta}
    t = load_transcriber(config, run_dir, device=dev)
    launches, checks = {}, {}
    for split, manifest in (
            ("heldout", os.path.join(work_dir, "heldout_manifest.json")),
            ("traindist", traindist_manifest)):
        refs, sigs = read_split(manifest)
        before = kernel_launches()
        hyps = [h.strip() for h in t.transcribe_batch(sigs)]
        launches[f"{split}_offline"] = _launches_since(before)
        out[f"{split}_utts"] = len(refs)
        out[f"{split}_offline_wer"] = round(word_error_rate(hyps, refs), 4)
        out[f"{split}_offline_cer"] = round(
            word_error_rate(hyps, refs, use_cer=True), 4)
        before = kernel_launches()
        s_hyps = _streaming_decode(cfg, run_dir, sigs, device=dev)
        if s_hyps is not None:
            launches[f"{split}_streaming"] = _launches_since(before)
            out[f"{split}_streaming_wer"] = round(
                word_error_rate(s_hyps, refs), 4)
            out[f"{split}_streaming_cer"] = round(
                word_error_rate(s_hyps, refs, use_cer=True), 4)
        if cfg.architecture == "quartznet":
            r = kernel_route_check(config, run_dir, sigs, device=dev)
            g = r["gate"]
            checks[split] = {
                "offline_wer_bf16": round(word_error_rate(r["hyps"], refs),
                                          4),
                "plain_offline_wer_bf16": round(
                    word_error_rate(r["plain_hyps"], refs), 4),
                "transcripts_equal": r["equal"],
                "d_k": g["d_k"], "d_p": g["d_p"], "d_ratio": g["d_ratio"],
                "bar": g["bar"],
                "max_abs_dlogp": g["max_abs_dlogp"],
                "worst_at_logp": (g["worst"] or {}).get("logp_ref"),
                "tol": E2E_LOGP_TOL,
                "gate": g,
                "tf32": r["tf32"],
                "first_block_past_one_step": r["first_block_past_one_step"],
                "blocks": r["blocks"],
                "head": r["head"],
                "launches": r["launches"],
                "plain_launches": r["plain_launches"]}
    # back-compat aliases (the JAX artifacts' round-4 schema)
    out["offline_wer"] = out["heldout_offline_wer"]
    out["offline_cer"] = out["heldout_offline_cer"]
    out["port"] = "vietasr_tpu_torch"
    out["device"] = device_line(dev)
    out["launches"] = launches
    if checks:
        out["kernel_route"] = checks
    summary_path = os.path.join(run_dir, "train_summary.json")
    if os.path.exists(summary_path):
        with open(summary_path) as f:
            out["train"] = json.load(f)
    print(json.dumps(out, ensure_ascii=False))
    os.makedirs(art_dir, exist_ok=True)
    for d in (work_dir, art_dir):
        with open(os.path.join(d, f"torch_synth_{tag}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(out, f, ensure_ascii=False, indent=1)
    log_path = os.path.join(run_dir, "train_log.jsonl")
    if os.path.exists(log_path):
        shutil.copy(log_path, os.path.join(art_dir,
                                           f"torch_train_{tag}.jsonl"))
    if checks and not checks["heldout"]["gate"]["ok"]:
        raise RuntimeError("held-out: the kernel route from fp32: "
                           + gate_line(checks["heldout"]["gate"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", required=True,
                    choices=["corpus", "train", "eval"])
    ap.add_argument("--work-dir", default="work/synthlang_torch")
    ap.add_argument("--config", default=QN_CONFIG)
    ap.add_argument("--tag", default="qn")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--n-heldout", type=int, default=64)
    ap.add_argument("--optimizer", default="novograd")
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--dropout", type=float, default=None)
    ap.add_argument("--aug", default="speed,gain,noise",
                    help="comma list of per-read perturbations "
                         "(subset of speed,gain,noise; empty = clean)")
    ap.add_argument("--sig", default="v2", choices=["v1", "v2"],
                    help="char signature family (v1 narrowband formant "
                         "pairs; v2 speed-robust broadband)")
    ap.add_argument("--normalize", default=None,
                    help="featurizer normalize override (e.g. "
                         "causal_per_feature for streaming-matched "
                         "training)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="conformer depth override")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="init and dropout seed (the data seed stays 0)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop training at this step (the schedule still "
                         "spans --steps)")
    ap.add_argument("--art-dir", default=ART_DIR,
                    help="eval: where torch_synth_<tag>.json and "
                         "torch_train_<tag>.jsonl go")
    args = ap.parse_args(argv)

    from vietasr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)
    if args.phase == "corpus":
        phase_corpus(args.work_dir, args.n_heldout,
                     study_config(args.config).labels, args.sig)
    elif args.phase == "train":
        aug = tuple(a for a in args.aug.split(",") if a)
        phase_train(args.work_dir, args.config, args.tag, args.steps,
                    args.batch_size, args.lr, args.optimizer, args.warmup,
                    args.dropout, aug, args.sig, args.normalize,
                    args.num_blocks, device=dev, seed=args.seed,
                    max_steps=args.max_steps)
    elif args.phase == "eval":
        phase_eval(args.work_dir, args.config, args.tag, args.sig,
                   device=dev, art_dir=args.art_dir)


if __name__ == "__main__":
    main()
