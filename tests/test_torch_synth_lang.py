"""tools/synth_lang_run_torch.py (the synthetic-language study on the
port) against tools/synth_lang_run.py (the JAX package's), on the CPU, on
the same seeds:

- the corpus: the word bank (v1 and v2 signatures), `phase_corpus`'s
  held-out WAVs and manifest and `_write_traindist`'s, byte for byte;
- the data stream: the first 64 `SynthDynamicDataset` reads of a recipe
  (seed 0, speed + gain + noise) bit for bit, and one epoch of the
  recipe's `BucketBatcher` at B = 32 equal batch for batch;
- training: a recipe's model, narrow (QuartzNet: 3 blocks, widths 32-48;
  the 16-block stack Conformer and the 6-block chunked one at width 32;
  fp32, dither 0, dropout 0), takes 3 study steps through each tool's
  `phase_train` under the recipe's optimizer and schedule (`qn_v2`'s
  Novograd; `stack16lw_v2`'s and `stream6_v2`'s AdamW with warmup), from
  JAX's init (carried into the port by its resume path:
  `CheckpointManager` reads JAX's checkpoint through `params_from_jax`
  and the optax state). Loss, grad norm and lr within 1e-4 relative:
  fp32 forward and backward over B = 4 x up to 7.8 s, summed in another
  order, and from step 2 on the optimizer moves every parameter by ~lr
  times the gradient's relative error;
- the flags of every recipe the port has trained on the card (the meta
  its run recorded) against the meta of JAX's run of it;
- eval, on carried weights (a narrow QuartzNet and a narrow chunked
  Conformer, JAX's init with the head scaled 40x): the port's offline
  loader gives JAX's `_load_transcriber` transcripts exactly; the two
  streamers with no normalization give the same log-probs (1e-3 at the
  head's scale); through `_streaming_decode` (causal running stats, as
  both tools stream) each tool's transcript is its stream's greedy text,
  and the two streams' frame argmax agree but at near-ties within their
  difference at that frame (the stats divide near-empty mel bins of the
  synthetic tones by a small std, which amplifies the two fp32 log-mel
  routes' difference: max |d log p| measured 0.35 and 8.4 at the 40x
  heads, largest at the first frames; 1 of ~700 and 4 of 343 frames
  differ), the transcripts then equal; and the port's `phase_eval`
  scores the transcripts as JAX's metric does, with JAX's keys.
"""

import dataclasses
import importlib
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

import vietasr_tpu.train as jax_train
from vietasr_tpu.audio import BucketBatcher as JaxBatcher
from vietasr_tpu.audio import CharTokenizer as JaxTokenizer
from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.models import model_init as jax_model_init
from vietasr_tpu_torch.config import (BlockConfig, EncoderConfig,
                                      load_config, save_config)
from vietasr_tpu_torch.train.metrics import word_error_rate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
CONFORMER_CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                                "conformer_ctc_vi_s_streaming.yaml")
STACK_CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                            "conformer_ctc_vi_stack.yaml")
JAX_TOOL = importlib.import_module("tools.synth_lang_run")
JAX_HELDOUT = importlib.import_module("tools.heldout_wer_run")
TOOL = importlib.import_module("tools.synth_lang_run_torch")
LABELS = load_config(CONFIG).labels
STEP_RTOL = 1e-4
# streamed log-probs, port vs JAX, on the narrow models' 40x heads (log p
# down to ~-35), with no normalization: the fp32 contract at the head's
# scale (measured 1.9e-4 and 9e-5). With the causal running stats the
# difference is amplified: see test_eval_transcripts_match_jax
STREAM_TOL = 1e-3
# a narrow QuartzNet with 12x1's three kinds of block (strided separable,
# residual separable, dense 1x1), streamable by OnlineTranscriber
BLOCKS = [dict(filters=32, kernel=33, stride=2, residual=False,
               separable=True),
          dict(filters=32, kernel=15, stride=1, residual=True,
               separable=True),
          dict(filters=48, kernel=1, stride=1, residual=False,
               separable=False)]


def narrow_yaml(folder, arch="quartznet") -> str:
    """quartznet12x1_vi.yaml with a narrow encoder;
    conformer_ctc_vi_s_streaming.yaml with 2 blocks of width 32 and
    chunks of 4 frames (2 to the left) ("conformer"), or at its own 6
    blocks and chunking ("stream6"); or conformer_ctc_vi_stack.yaml at its
    16 blocks ("stack"), each Conformer of width 32 with kernel 7 (the
    deep ones with scan_blocks); dither 0 and dropout 0, written by the
    port's save_config (the bytes the JAX package writes and reads)."""
    if arch == "quartznet":
        cfg = load_config(CONFIG)
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, blocks=tuple(BlockConfig(**b) for b in BLOCKS)))
    else:
        cfg = load_config(STACK_CONFIG if arch == "stack"
                          else CONFORMER_CONFIG)
        # the recipes' depths compile as one scanned block in JAX (the
        # same math as the unrolled stack; the port loops either way)
        cut = dict(num_blocks=2, chunk_size=4, left_chunks=2) \
            if arch == "conformer" else dict(scan_blocks=True)
        cfg = dataclasses.replace(cfg, conformer=dataclasses.replace(
            cfg.conformer, d_model=32, num_heads=2, subsampling_channels=32,
            conv_kernel=7, dropout=0.0, **cut))
    cfg = dataclasses.replace(
        cfg, featurizer=dataclasses.replace(cfg.featurizer, dither=0.0))
    path = os.path.join(str(folder), f"narrow_{arch}.yaml")
    save_config(cfg, path)
    return path


def _lines(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(l) for l in f]


def _same_files(jax_dir, port_dir, manifest):
    """The two tools' manifests name the same utterances (paths relative to
    their work dirs) and their WAVs are equal byte for byte."""
    want, got = (_lines(os.path.join(d, manifest)) for d in (jax_dir,
                                                             port_dir))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert os.path.relpath(g["audio_filepath"], port_dir) == \
            os.path.relpath(w["audio_filepath"], jax_dir)
        assert (g["duration"], g["text"]) == (w["duration"], w["text"])
        with open(g["audio_filepath"], "rb") as fg, \
                open(w["audio_filepath"], "rb") as fw:
            assert fg.read() == fw.read()
    return got


# ---------------------------------------------------------------------------
# the corpus


@pytest.mark.parametrize("sig", ["v1", "v2"])
def test_word_bank_matches_jax(sig):
    want = JAX_TOOL.make_bank(LABELS, sig)
    got = TOOL.make_bank(LABELS, sig)
    assert TOOL.WORDS == JAX_TOOL.WORDS
    assert sorted(got) == sorted(want) and len(got) == 62
    for w in want:
        assert got[w].dtype == np.float32
        np.testing.assert_array_equal(got[w], want[w])
    assert TOOL.heldout_sequences(got, 64) == \
        JAX_TOOL.heldout_sequences(want, 64)


def test_corpus_and_traindist_match_jax(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jax_dir, port_dir):
        os.makedirs(d)
    JAX_TOOL.phase_corpus(jax_dir, 64, LABELS, "v2")
    TOOL.phase_corpus(port_dir, 64, LABELS, "v2")
    held = _same_files(jax_dir, port_dir, "heldout_manifest.json")
    assert len(held) == 64

    bank = TOOL.make_bank(LABELS, "v2")
    exclude = set(TOOL.heldout_sequences(bank, 64))
    JAX_TOOL._write_traindist(jax_dir, JAX_TOOL.make_bank(LABELS, "v2"), 64,
                              exclude)
    path = TOOL._write_traindist(port_dir, bank, 64, exclude)
    assert path == os.path.join(port_dir, "traindist_manifest.json")
    dist = _same_files(jax_dir, port_dir, "traindist_manifest.json")
    assert len(dist) == 64
    held_texts = {e["text"] for e in held}
    assert not held_texts & {e["text"] for e in dist}


# ---------------------------------------------------------------------------
# the data stream


def _jax_dataset(batch_size, aug=TOOL.AUG):
    """The JAX tool's training dataset as its phase_train builds it."""
    bank = JAX_TOOL.make_bank(LABELS, "v2")
    exclude = set(JAX_TOOL.heldout_sequences(bank, 64))
    return JAX_TOOL.SynthDynamicDataset(bank, JaxTokenizer(LABELS), seed=0,
                                        size=batch_size * 64,
                                        exclude=exclude, aug=aug)


def test_first_64_reads_match_jax_bit_for_bit():
    want_ds = _jax_dataset(32)
    got_ds = TOOL.study_batcher(LABELS, 32).ds
    assert [e.duration for e in got_ds.entries] == \
        [e.duration for e in want_ds.entries]
    speeds = set()
    for i in range(64):
        (got, got_ids), (want, want_ids) = got_ds[i], want_ds[i]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert list(got_ids) == list(want_ids)
        speeds.add(len(got))
    assert len(speeds) > 32         # augmented, composed afresh per read


def test_batcher_epoch_matches_jax():
    """One epoch of the recipe's BucketBatcher (B = 32, 2,048 reads)."""
    got = TOOL.study_batcher(LABELS, 32)
    want = JaxBatcher(_jax_dataset(32), 32, max_duration=7.0,
                      bucket_margin=1.12)
    assert got.buckets == want.buckets
    assert got.steps_per_epoch() == want.steps_per_epoch()
    it_g, it_w, n = iter(got), iter(want), 0
    while True:
        g, w = next(it_g, None), next(it_w, None)
        assert (g is None) == (w is None)
        if g is None:
            break
        for key in ("signal", "signal_lens", "tokens", "token_lens"):
            np.testing.assert_array_equal(getattr(g, key), getattr(w, key))
        n += 1
    assert n == got.steps_per_epoch()
    assert want.epoch == got.epoch == 1


# ---------------------------------------------------------------------------
# three study steps


class _ThreeSteps(jax_train.Trainer):
    """JAX's Trainer as its phase_train builds it, less the bf16 compute
    (fp32 here) and cut to the batcher's first 3 batches, logging each."""

    def __post_init__(self):
        self.compute_dtype = None
        self.log_every = 1
        super().__post_init__()

    def fit(self, state, batcher, *, num_epochs=1, eval_batcher=None):
        it = iter(batcher)
        return super().fit(state, [next(it) for _ in range(3)],
                           num_epochs=1)


# a recipe's model, narrow, and its flags at B = 4: qn_v2's; stack16lw_v2's
# 16-block stack Conformer (AdamW, lr 1e-3, a 2,500-step warmup; stack_v2
# is the same model under stream6_v2's schedule); stream6_v2's chunked
# Conformer with its depth given as the recipe gives it (--num-blocks 6)
STUDY_STEPS = {
    "qn_v2": ("quartznet", dict(steps=2500, lr=0.01, optimizer="novograd")),
    "stack16lw_v2": ("stack", dict(steps=7000, lr=0.001, optimizer="adamw",
                                   warmup=2500)),
    "stream6_v2": ("stream6", dict(steps=4000, lr=0.002, optimizer="adamw",
                                   warmup=500, num_blocks=6)),
}


@pytest.mark.parametrize("recipe", sorted(STUDY_STEPS))
def test_three_study_steps_match_jax(tmp_path, monkeypatch, recipe):
    arch, kw = STUDY_STEPS[recipe]
    config = narrow_yaml(tmp_path, arch)
    kw = dict(kw, batch_size=4)
    monkeypatch.setattr(jax_train, "Trainer", _ThreeSteps)
    jax_dir = str(tmp_path / "jax")
    JAX_TOOL.phase_train(jax_dir, config, "t", **kw)

    # JAX's init and optimizer state at step 0, as its phase_train makes
    # them, in the port's run dir: the port resumes from it
    jcfg = jax_load_config(config)
    if kw.get("num_blocks") is not None:
        jcfg = jax_load_config(os.path.join(jax_dir, "run_t",
                                            "config.yaml"))
        assert jcfg.conformer.num_blocks == kw["num_blocks"]
    opt = jax_train.make_optimizer(
        kw["optimizer"], jax_train.make_schedule(
            "CosineAnnealing", kw["lr"], 100, warmup_steps=5),
        weight_decay=0.001, grad_clip_norm=5.0)
    state = jax_train.TrainState.create(
        jax_model_init(jax.random.PRNGKey(0), jcfg), opt)
    port_dir = str(tmp_path / "port")
    jax_train.CheckpointManager(os.path.join(port_dir, "run_t")).save(state)
    summary = TOOL.phase_train(port_dir, config, "t", **kw, device="cpu",
                               max_steps=3, log_every=1, compute_dtype=None)
    assert (summary["start_step"], summary["end_step"]) == (0, 3)
    # the schedule spans JAX's whole epochs of 65 batches at B = 4
    assert summary["steps_per_epoch"] == 65
    assert summary["recipe_steps"] == kw["steps"] // 65 * 65 == \
        summary["epochs"] * summary["steps_per_epoch"]

    want = _lines(os.path.join(jax_dir, "run_t", "train_log.jsonl"))
    got = _lines(os.path.join(port_dir, "run_t", "train_log.jsonl"))
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert np.isfinite(g["loss"]) and g["loss"] > 0
        for key in ("loss", "grad_norm", "lr"):
            assert abs(g[key] - w[key]) <= STEP_RTOL * abs(w[key]), \
                (key, g, w)
    with open(os.path.join(port_dir, "run_t", "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jax_dir, "run_t", "meta.json")) as f:
        jax_meta = json.load(f)
    # a patched config is each run dir's own config.yaml, the same bytes
    assert os.path.relpath(meta.pop("config"), port_dir) == \
        os.path.relpath(jax_meta.pop("config"), jax_dir)
    assert meta.pop("init_seed") == 0 and meta == jax_meta
    if kw.get("num_blocks") is not None:
        with open(os.path.join(port_dir, "run_t", "config.yaml"), "rb") as f, \
                open(os.path.join(jax_dir, "run_t", "config.yaml"),
                     "rb") as fj:
            assert f.read() == fj.read()


# the JAX study's recipes that the port has trained on the card
# (artifacts/study/torch_synth_<tag>.json beside JAX's synth_<tag>.json)
PORTED_RECIPES = ("qn_v2", "qn_causal2_v2", "stack6_v2", "stream6c_v2",
                  "stream6_v2", "stack_v2", "stack16lw_v2")
RECIPE_FLAGS = ("optimizer", "lr", "warmup", "steps", "normalize",
                "num_blocks", "batch_size", "aug", "signatures", "dropout")


@pytest.mark.parametrize("tag", PORTED_RECIPES)
def test_ported_recipe_flags_match_jax(tag):
    """The port's run of a recipe took JAX's flags: its recorded meta
    (phase_train's meta.json, kept by phase_eval) against the meta of
    JAX's run, flag for flag; the steps it reached are recorded."""
    study = os.path.join(ROOT, "artifacts", "study")
    with open(os.path.join(study, f"synth_{tag}.json")) as f:
        want = json.load(f)["meta"]
    with open(os.path.join(study, f"torch_synth_{tag}.json")) as f:
        got = json.load(f)
    meta = got["meta"]
    assert {k: meta[k] for k in RECIPE_FLAGS} == \
        {k: want[k] for k in RECIPE_FLAGS}
    assert meta["tag"] == tag and meta["init_seed"] in (0, 1)
    assert 0 < meta["steps_reached"] <= meta["steps"]
    assert got["train"]["end_step"] == meta["steps_reached"]
    assert os.path.exists(os.path.join(study, f"torch_train_{tag}.jsonl"))


# ---------------------------------------------------------------------------
# eval on carried weights


def _carried_run(work_dir, config):
    """A JAX checkpoint of a narrow model whose head is scaled up (so its
    frames' argmax spread over the labels, not all blank) in
    work_dir/run_e, read by both tools' loaders."""
    jcfg = jax_load_config(config)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model_init(jax.random.PRNGKey(3), jcfg))
    head = variables["params"]["decoder"]
    head["w"] = head["w"] * 40.0
    state = jax_train.TrainState.create(variables,
                                        jax_train.make_optimizer("sgd", 0.1))
    jax_train.CheckpointManager(os.path.join(work_dir, "run_e")).save(state)
    return jcfg


def _streamed_log_probs(jcfg, cfg, run_dir, sigs, causal_norm=True):
    """Each utterance's streamed log-probs through JAX's online runtime
    and the port's, chunked as both tools' `_streaming_decode` chunk."""
    from vietasr_tpu.models.quartznet import fold_batchnorm as jax_fold
    from vietasr_tpu.streaming_conformer import \
        ConformerOnlineTranscriber as JaxConformerOnline
    from vietasr_tpu.streaming_online import OnlineTranscriber as JaxOnline
    from vietasr_tpu_torch.models.quartznet import fold_batchnorm
    from vietasr_tpu_torch.streaming_conformer import \
        ConformerOnlineTranscriber
    from vietasr_tpu_torch.streaming_online import OnlineTranscriber

    jv = jax_train.CheckpointManager(run_dir).restore_variables(
        jax_model_init(jax.random.PRNGKey(0), jcfg))
    pv = TOOL.restore_variables(run_dir, torch.device("cpu"))
    if cfg.architecture == "conformer":
        jot = JaxConformerOnline(jcfg, jv, causal_norm=causal_norm)
        ot = ConformerOnlineTranscriber(cfg, pv, causal_norm=causal_norm,
                                        device="cpu")
        cs = ot.required_chunk_samples
    else:
        jot = JaxOnline(jcfg, jax_fold(jv, jcfg.encoder),
                        causal_norm=causal_norm)
        ot = OnlineTranscriber(cfg, fold_batchnorm(pv, cfg.encoder),
                               causal_norm=causal_norm, device="cpu")
        cs = 3200
    jax_lp, port_lp = [], []
    for sig in sigs:
        padded = np.concatenate([sig, np.zeros((-len(sig)) % cs,
                                               np.float32)])
        chunks = [padded[i:i + cs] for i in range(0, len(padded), cs)]
        jax_lp.append(np.asarray(jot.stream(chunks, true_samples=len(sig))))
        port_lp.append(ot.stream(chunks, true_samples=len(sig)))
    return jax_lp, port_lp


@pytest.mark.parametrize("arch", ["quartznet", "conformer"])
def test_eval_transcripts_match_jax(tmp_path, arch):
    config = narrow_yaml(tmp_path, arch)
    work = str(tmp_path / "work")
    os.makedirs(work)
    jcfg = _carried_run(work, config)
    TOOL.phase_corpus(work, 8, LABELS, "v2")
    bank = TOOL.make_bank(LABELS, "v2")
    TOOL._write_traindist(work, bank, 8,
                          set(TOOL.heldout_sequences(bank, 64)))
    run_dir = os.path.join(work, "run_e")
    refs, sigs = TOOL.read_split(os.path.join(work,
                                              "heldout_manifest.json"))

    want = [h.strip() for h in JAX_HELDOUT._load_transcriber(
        config, run_dir).transcribe_batch(sigs)]
    got = [h.strip() for h in TOOL.load_transcriber(
        config, run_dir, device="cpu").transcribe_batch(sigs)]
    assert got == want
    assert len(set(want)) == len(want) and all(want)   # not degenerate
    want_s = JAX_TOOL._streaming_decode(jcfg, run_dir, sigs)
    got_s = TOOL._streaming_decode(load_config(config), run_dir, sigs,
                                   device="cpu")
    assert all(want_s) and len(got_s) == len(want_s)
    # the streamers without normalization: the same log-probs
    for lp, jlp in zip(*_streamed_log_probs(jcfg, load_config(config),
                                            run_dir, sigs, False)):
        assert lp.shape == jlp.shape
        assert np.abs(lp - jlp).max() <= STREAM_TOL
    # with the causal running stats (the study's streaming): they divide
    # each mel bin by its std so far (+ 1e-2), and the synthetic tones
    # leave bins nearly empty, whose log the two fp32 DFT routes give
    # differently; that reaches log p amplified, most at the first frames.
    # Transcripts are equal where no frame's decision is a near-tie within
    # that difference; each tool's transcript is its stream's greedy text
    jax_lp, port_lp = _streamed_log_probs(jcfg, load_config(config),
                                          run_dir, sigs)
    for got_text, want_text, lp, jlp in zip(got_s, want_s, port_lp,
                                            jax_lp):
        assert lp.shape == jlp.shape
        assert got_text == TOOL._greedy_text(lp, LABELS)
        assert want_text == JAX_TOOL._greedy_text(jlp, LABELS)
        d = np.abs(lp - jlp).max(-1)
        frames = np.nonzero(lp.argmax(-1) != jlp.argmax(-1))[0]
        for t in frames:
            margin = jlp[t].max() - jlp[t, lp[t].argmax()]
            assert margin <= 2 * d[t], (t, margin, d[t])
        if not len(frames):
            assert got_text == want_text

    art = str(tmp_path / "art")
    out = TOOL.phase_eval(work, config, "e", device="cpu", art_dir=art)
    assert out["heldout_offline_wer"] == round(word_error_rate(want, refs), 4)
    assert out["heldout_offline_cer"] == round(
        word_error_rate(want, refs, use_cer=True), 4)
    assert out["heldout_streaming_wer"] == round(
        word_error_rate(want_s, refs), 4)
    with open(os.path.join(ROOT, "artifacts", "study",
                           "synth_qn_v2.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(out)
    assert (out["port"], out["device"], out["heldout_utts"],
            out["traindist_utts"]) == ("vietasr_tpu_torch", "cpu", 8, 8)
    if arch == "quartznet":
        # on the CPU both routes are the plain version: identical
        check = out["kernel_route"]["heldout"]
        assert check["max_abs_dlogp"] == 0.0
        assert check["transcripts_equal"] == 8
    else:
        assert "kernel_route" not in out
    with open(os.path.join(art, "torch_synth_e.json"),
              encoding="utf-8") as f:
        assert json.load(f) == out
    assert not re.search(r"(^|/)synth_e\.json$", " ".join(os.listdir(art)))
