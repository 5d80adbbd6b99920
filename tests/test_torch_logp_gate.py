"""The end-to-end gate of a bf16 kernel route against the plain route
(`logp_gate` in tools/synth_lang_run_torch.py, which chip_smoke.py applies
at every bf16 kernel-vs-plain site), on the CPU: every entry (a class at
a frame) within |d log p| <= 0.25, with what moved recorded.

Synthetic bf16 logits go through fp32 log_softmax, as the models' heads
do, with the kernel route's logits moved by whole bf16 steps. A step
that flips at a logit in [32, 64) (0.25) or [64, 128) (0.5) fails like
any other entry past 0.25: the per-step widening that ROADMAP C.1
proposed was refuted on the trained QuartzNets (their entries past 0.25
sit at logits below 20, 0.67 to 7.6 bf16 steps apart), so the gate stays
the old one, at every magnitude. Each case checks the verdict and the
evidence: both logits, the bf16 step at them, the steps moved and the
row's d log Z. Then `phase_eval` on a narrow QuartzNet records the gate
for both splits under `kernel_route` and raises on the held-out one.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

from vietasr_tpu_torch.config import BlockConfig, load_config, save_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = importlib.import_module("tools.synth_lang_run_torch")
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
# one row of bf16 logits: a dominant class at 10, one far class in each of
# [16, 32), [32, 64) and [64, 128)
ROW = [10.0, 4.0, 2.5, -3.0, -12.0, -40.0, -80.0, -20.0]


def _log_softmax(lg):
    return torch.log_softmax(torch.from_numpy(lg), dim=-1).numpy()


def _routes(edits=(), shift=0.0):
    """(lp, lp_ref, logits, logits_ref) for two rows of ROW, the kernel
    route's first row with `edits` ((class, new logit), ...) and `shift`
    added to every class; every value bf16."""
    ref = np.array([ROW, ROW], np.float32)
    lg = ref.copy()
    for c, v in edits:
        lg[0, c] = v
    lg[0] += np.float32(shift)
    for a in (lg, ref):
        assert np.array_equal(
            torch.from_numpy(a).to(torch.bfloat16).float().numpy(), a)
    return _log_softmax(lg), _log_softmax(ref), lg, ref


# (case, the kernel route's edits, row shift, ok, the worst entry's
# (class, bf16 ulp, steps), its row's |d log Z| to 1e-3). Moving the
# dominant class by one step (0.0625) moves log Z by ~0.062
CASES = [
    ("identical", (), 0.0, True, None, 0.0),
    ("one step in [32, 64), 0.25 + 0.06", ((5, -39.75), (0, 9.9375)), 0.0,
     False, (5, 0.25, 1.0), 0.062),
    ("one step in [64, 128), 0.5 + 0.06", ((6, -79.5), (0, 9.9375)), 0.0,
     False, (6, 0.5, 1.0), 0.062),
    ("two steps in [32, 64), 0.5", ((5, -39.5),), 0.0, False,
     (5, 0.25, 2.0), 0.0),
    ("0.31 below 32, two steps", ((7, -20.25), (0, 10.0625)), 0.0, False,
     (7, 0.125, 2.0), 0.062),
    ("0.19 below 32, one step", ((7, -20.125), (0, 10.0625)), 0.0, True,
     (7, 0.125, 1.0), 0.062),
    # the gate reads log p: a shift of the whole row moves only log Z
    ("row log Z +0.5, log p equal", (), 0.5, True, None, 0.5),
]


@pytest.mark.parametrize("case,edits,shift,ok,worst,dlogz", CASES,
                         ids=[c[0] for c in CASES])
def test_gate_cases(case, edits, shift, ok, worst, dlogz):
    lp, lp_ref, lg, lg_ref = _routes(edits, shift)
    g = TOOL.logp_gate([(lp, lp_ref, lg, lg_ref)])
    d = np.abs(lp - lp_ref)
    assert g["ok"] is ok is bool(d.max() <= 0.25), (case, g["failed"])
    assert g["tol"] == TOOL.E2E_LOGP_TOL == 0.25
    assert g["max_abs_dlogp"] == float(d.max())
    assert g["past_tol"] == int((d > 0.25).sum()) == len(g["entries"])
    assert g["max_row_dlogz"] == pytest.approx(dlogz, abs=1e-3)
    assert g["max_abs_logit"] == 80.0 + (shift if shift < 0 else 0.0)
    w = g["worst"]
    assert (w["item"], w["row"]) == (0, 0) and w["dlogp"] == d.max()
    if worst is not None:
        assert (w["cls"], w["ulp"], w["steps"]) == worst
        assert w["row_dlogz"] == pytest.approx(dlogz, abs=1e-3)
        # d log p = d logit - d log Z
        dz = float(torch.logsumexp(torch.from_numpy(lg[0]).double(), 0)
                   - torch.logsumexp(torch.from_numpy(lg_ref[0]).double(), 0))
        assert abs(dz) == pytest.approx(w["row_dlogz"], abs=1e-6)
        assert w["logp"] - w["logp_ref"] == pytest.approx(
            w["logit"] - w["logit_ref"] - dz, abs=1e-5)
    if ok:
        assert g["failed"] is None and g["entries"] == []
    else:
        assert g["entries"][0] == w and g["max_steps_past_tol"] == worst[2]
        assert g["failed"].startswith(f"|d log p| {w['dlogp']} > 0.25")
    assert ("FAILED" in TOOL.gate_line(g)) is (not ok)


def test_bf16_step():
    x = np.array([1.0, -1.5, 16.0, 31.875, 32.0, -63.75, 64.0, -127.5,
                  128.0, 0.0], np.float32)
    want = [2.0 ** -7, 2.0 ** -7, 0.125, 0.125, 0.25, 0.25, 0.5, 0.5, 1.0,
            2.0 ** -133]
    np.testing.assert_array_equal(TOOL.bf16_step(x), np.float32(want))
    # the step is the spacing of bf16 values there
    for v in (1.0, 20.0, -40.0, 100.0):
        step = float(TOOL.bf16_step(v))
        for dv, want in ((step, v + step), (step / 4, v)):
            assert float(torch.tensor(v + dv).to(torch.bfloat16)) == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gate_is_max_abs_dlogp_at_every_magnitude(seed):
    """Rows of 16 bf16 logits in (-100, 100), the kernel route's moved by
    -3 to 3 steps at three classes: the gate passes a row exactly where
    its max |d log p| is within 0.25, and counts each entry's steps."""
    rng = np.random.RandomState(seed)
    outcomes = set()
    for _ in range(60):
        ref = torch.from_numpy(rng.uniform(-100, 100, 16).astype(np.float32))
        ref = ref.to(torch.bfloat16).float().numpy()
        lg = ref.copy()
        for c in rng.choice(16, size=3, replace=False):
            lg[c] += rng.randint(-3, 4) * TOOL.bf16_step(lg[c])
        lg = torch.from_numpy(lg).to(torch.bfloat16).float().numpy()
        lp, lp_ref = _log_softmax(lg[None]), _log_softmax(ref[None])
        g = TOOL.logp_gate([(lp, lp_ref, lg[None], ref[None])])
        d = np.abs(lp - lp_ref)[0]
        assert g["ok"] == bool(d.max() <= 0.25), g
        for e in g["entries"]:
            c = e["cls"]
            assert e["steps"] == abs(lg[c] - ref[c]) / TOOL.bf16_step(
                max(abs(lg[c]), abs(ref[c])))
        outcomes.add(g["ok"])
    assert outcomes == {True, False}


def test_gate_reads_torch_and_many_items():
    """Torch tensors and items of other shapes: the worst entry is named
    by its item, row and class; a shape mismatch raises."""
    a = _routes()
    b = _routes(((6, -79.5), (0, 9.9375)))
    g = TOOL.logp_gate([tuple(torch.from_numpy(x) for x in a),
                        tuple(x[:1, None] for x in b)])
    assert not g["ok"] and g["past_tol"] == 1
    assert (g["worst"]["item"], g["worst"]["row"], g["worst"]["cls"]) == \
        (1, 0, 6)
    with pytest.raises(ValueError):
        TOOL.logp_gate([(a[0], a[1][:1], a[2], a[3])])


# ---------------------------------------------------------------------------
# phase_eval


def _narrow_run(work):
    """A narrow QuartzNet (3 blocks, widths 32-48, dither 0) from the
    port's init, its checkpoint in work/run_g, and an 8-utterance corpus."""
    from vietasr_tpu_torch.models import model_init
    from vietasr_tpu_torch.train import (CheckpointManager, TrainState,
                                         make_optimizer)

    cfg = load_config(CONFIG)
    cfg = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, blocks=(
            BlockConfig(filters=32, kernel=33, stride=2, residual=False,
                        separable=True),
            BlockConfig(filters=32, kernel=15, stride=1, residual=True,
                        separable=True),
            BlockConfig(filters=48, kernel=1, stride=1, residual=False,
                        separable=False))),
        featurizer=dataclasses.replace(cfg.featurizer, dither=0.0))
    config = os.path.join(work, "narrow.yaml")
    save_config(cfg, config)
    gen = torch.Generator().manual_seed(3)
    state = TrainState.create(model_init(gen, cfg, device="cpu"),
                              make_optimizer("sgd", 0.1))
    CheckpointManager(os.path.join(work, "run_g"), device="cpu").save(state)
    TOOL.phase_corpus(work, 8, cfg.labels, "v2")
    bank = TOOL.make_bank(cfg.labels, "v2")
    TOOL._write_traindist(work, bank, 8,
                          set(TOOL.heldout_sequences(bank, 64)))
    return config


# the kernel route's logit at frame 0, class 1 (set to -80 on both routes)
# moved by `move` on the splits named: the gate records both splits and
# raises on the held-out one alone
@pytest.mark.parametrize("move,splits,raises", [
    (0.0, ("heldout", "traindist"), False),
    (0.25, ("heldout", "traindist"), False),
    (0.5, ("heldout", "traindist"), True),
    (0.5, ("traindist",), False)])
def test_phase_eval_records_and_raises_on_the_gate(tmp_path, monkeypatch,
                                                   move, splits, raises):
    work = str(tmp_path)
    config = _narrow_run(work)
    with_logits, calls = TOOL.with_logits, []

    def moved(fn, *args, **kwargs):
        (lp, el), lg = with_logits(fn, *args, **kwargs)
        # kernel_route_check's calls: 2 a clip, 8 held-out clips first
        split = "heldout" if len(calls) < 16 else "traindist"
        calls.append(split)
        lg = lg.copy()
        lg[0, 0, 1] = -80.0
        if fn.__self__.opts.block_impl != "plain" and split in splits:
            lg[0, 0, 1] += move
        return (_log_softmax(lg), el), lg

    monkeypatch.setattr(TOOL, "with_logits", moved)
    monkeypatch.setattr(TOOL, "_streaming_decode", lambda *a, **k: None)
    art = str(tmp_path / "art")
    if raises:
        with pytest.raises(RuntimeError, match=r"held-out: .*FAILED"):
            TOOL.phase_eval(work, config, "g", device="cpu", art_dir=art)
        with open(os.path.join(art, "torch_synth_g.json")) as f:
            out = json.load(f)
    else:
        out = TOOL.phase_eval(work, config, "g", device="cpu", art_dir=art)
    assert len(calls) == 32
    for split in ("heldout", "traindist"):
        c = out["kernel_route"][split]
        g = c["gate"]
        assert set(g) >= {"ok", "failed", "tol", "max_abs_dlogp",
                          "max_row_dlogz", "max_abs_logit", "past_tol",
                          "max_steps_past_tol", "worst", "entries"}
        assert (c["max_abs_dlogp"], c["tol"]) == (g["max_abs_dlogp"], 0.25)
        assert c["transcripts_equal"] == 8
        # every clip's frame 0 moved: 8 entries, the rest equal
        want = move if split in splits else 0.0
        assert g["max_abs_dlogp"] == pytest.approx(want, abs=1e-5)
        assert g["past_tol"] == (8 if want > 0.25 else 0)
        assert g["ok"] is (want <= 0.25)
        if want:
            w = g["worst"]
            assert (w["row"], w["cls"], w["logit_ref"]) == (0, 1, -80.0)
            assert (w["ulp"], w["steps"]) == (0.5, want / 0.5)
            assert c["worst_at_logp"] == w["logp_ref"]
