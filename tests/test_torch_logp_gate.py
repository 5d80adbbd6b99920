"""The end-to-end gate of a bf16 kernel route (`logp_gate` in
tools/synth_lang_run_torch.py, which chip_smoke.py applies at every bf16
kernel-vs-plain site), on the CPU. Both bf16 routes are held to the fp32
forward on the same weights and signals: the kernel route's largest
|d log p| from it, d_k, within max(0.25, 1.5 d_p), d_p the plain route's;
the kernel route against the plain route is recorded beside it (every
entry past 0.25, its logits, bf16 steps and the row's d log Z) with the
verdict of the old kernel-vs-plain rule, which still decides items that
have no fp32 forward (two loads of one route).

Synthetic bf16 logits go through fp32 log_softmax, as the models' heads
do, with the kernel route's logits moved by whole bf16 steps and an fp32
row beside them. With the fp32 row equal to the plain route's, d_p is 0
and the verdict is the old one at every magnitude: a step that flips at
a logit in [32, 64) (0.25) or [64, 128) (0.5) fails like any other entry
past 0.25. Where the plain route itself lies off fp32 the bar grows to
1.5 d_p, and a kernel route farther than that fails. Each case checks the
verdict and the evidence. Then `phase_eval` on a narrow QuartzNet records
the gate, d_k, d_p, the block profile and the head for both splits under
`kernel_route` and raises on a fault injected into the held-out split's
kernel route.
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
    added to every class; every value bf16. The gate's fp32 row is the
    plain route's (`_with_fp32`)."""
    ref = np.array([ROW, ROW], np.float32)
    lg = ref.copy()
    for c, v in edits:
        lg[0, c] = v
    lg[0] += np.float32(shift)
    for a in (lg, ref):
        assert np.array_equal(
            torch.from_numpy(a).to(torch.bfloat16).float().numpy(), a)
    return _log_softmax(lg), _log_softmax(ref), lg, ref


def _with_fp32(quad):
    """The four arrays and an fp32 forward equal to the plain route."""
    return tuple(quad) + (quad[1], quad[3])


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
    g = TOOL.logp_gate([_with_fp32((lp, lp_ref, lg, lg_ref))])
    d = np.abs(lp - lp_ref)
    assert g["ok"] is ok is bool(d.max() <= 0.25), (case, g["failed"])
    assert g["kernel_vs_plain_ok"] is ok
    assert g["tol"] == TOOL.E2E_LOGP_TOL == 0.25
    assert (g["rule"], g["ratio"]) == ("fp32", TOOL.ROUTE_RATIO) \
        and TOOL.ROUTE_RATIO == 1.5
    # the plain route is the fp32 row: d_p 0, the bar 0.25, d_k the old max
    assert (g["d_k"], g["d_p"], g["bar"]) == (float(d.max()), 0.0, 0.25)
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
        assert (w["logp_fp32"], w["logit_fp32"]) == (w["logp_ref"],
                                                     w["logit_ref"])
    if ok:
        assert g["failed"] is None and g["entries"] == []
        assert g["kernel_vs_plain_failed"] is None
    else:
        assert g["entries"][0] == w and g["max_steps_past_tol"] == worst[2]
        assert g["kernel_vs_plain_failed"].startswith(
            f"|d log p| {w['dlogp']} > 0.25")
        assert g["failed"].startswith(
            f"the kernel route's |d log p| from fp32 {w['dlogp']} > 0.25")
        assert (g["worst_kernel"]["row"], g["worst_kernel"]["cls"]) == \
            (w["row"], w["cls"])
    line = TOOL.gate_line(g)
    assert ("FAILED" in line) is (not ok)
    assert line.startswith(f"from fp32: d_k {g['d_k']:.4e}, d_p 0.0000e+00")


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
        g = TOOL.logp_gate([_with_fp32((lp, lp_ref, lg[None], ref[None]))])
        d = np.abs(lp - lp_ref)[0]
        assert g["ok"] == g["kernel_vs_plain_ok"] == bool(d.max() <= 0.25)
        for e in g["entries"]:
            c = e["cls"]
            assert e["steps"] == abs(lg[c] - ref[c]) / TOOL.bf16_step(
                max(abs(lg[c]), abs(ref[c])))
        outcomes.add(g["ok"])
    assert outcomes == {True, False}


def test_gate_reads_torch_and_many_items():
    """Torch tensors and items of other shapes: the worst entry is named
    by its item, row and class; a shape mismatch, a count of arrays other
    than 4, 6 or 8, and items with and without an fp32 forward in one
    call raise."""
    a = _with_fp32(_routes())
    b = _with_fp32(_routes(((6, -79.5), (0, 9.9375))))
    g = TOOL.logp_gate([tuple(torch.from_numpy(x) for x in a),
                        tuple(x[:1, None] for x in b)])
    assert not g["ok"] and g["past_tol"] == 1
    assert (g["worst"]["item"], g["worst"]["row"], g["worst"]["cls"]) == \
        (1, 0, 6)
    assert (g["worst_kernel"]["item"], g["worst_kernel"]["cls"]) == (1, 6)
    with pytest.raises(ValueError):
        TOOL.logp_gate([(a[0], a[1][:1]) + a[2:]])
    with pytest.raises(ValueError):
        TOOL.logp_gate([a[:5]])
    with pytest.raises(ValueError):
        TOOL.logp_gate([a, a[:4]])


def _three(kernel_at_5, plain_at_5):
    """(lp, lp_ref, lg, lg_ref, lp_fp32, lg_fp32) for one row of ROW as
    the fp32 forward, the kernel and plain routes' class-5 logit (-40 in
    fp32) set to the values given."""
    f32 = np.array([ROW], np.float32)
    lg, ref = f32.copy(), f32.copy()
    lg[0, 5], ref[0, 5] = kernel_at_5, plain_at_5
    return (_log_softmax(lg), _log_softmax(ref), lg, ref, _log_softmax(f32),
            f32)


# (case, the kernel and plain routes' class-5 logit, the fp32 rule's and
# the kernel-vs-plain rule's verdicts). Class 5 lies far below the row's
# log Z, so its d log p is its d logit to ~1e-7
FP32_CASES = [
    ("off fp32 either way by 0.25", -39.75, -40.25, True, False),
    ("both off by 0.5 the same way", -39.5, -39.5, True, True),
    ("kernel 0.3, plain 0.25: ratio 1.2", -39.7, -40.25, True, False),
    ("kernel 0.2 within 0.25, plain 0", -39.8, -40.0, True, True),
    ("kernel 0.4, plain 0.25: ratio 1.6", -39.6, -40.25, False, False),
    ("kernel 0.5 alone", -39.5, -40.0, False, False),
    ("kernel 1.0, plain 0.5: ratio 2", -39.0, -40.5, False, False),
]


@pytest.mark.parametrize("case,k5,p5,ok,vs_plain_ok", FP32_CASES,
                         ids=[c[0] for c in FP32_CASES])
def test_gate_from_fp32(case, k5, p5, ok, vs_plain_ok):
    """The verdict d_k <= max(0.25, 1.5 d_p), each route from the fp32
    forward, beside the kernel-vs-plain rule's; the entries where each
    route lies farthest from fp32."""
    arrs = _three(k5, p5)
    g = TOOL.logp_gate([arrs])
    lp, lp_ref, _, _, lp32, _ = arrs
    d_k, d_p = (float(np.abs(a - lp32).max()) for a in (lp, lp_ref))
    assert d_k == pytest.approx(abs(k5 + 40), abs=1e-5)
    assert d_p == pytest.approx(abs(p5 + 40), abs=1e-5)
    assert (g["d_k"], g["d_p"]) == (d_k, d_p)
    assert g["bar"] == max(0.25, 1.5 * d_p)
    assert g["d_ratio"] == (d_k / d_p if d_p else None)
    assert g["ok"] is ok is (d_k <= max(0.25, 1.5 * d_p)), case
    assert g["kernel_vs_plain_ok"] is vs_plain_ok
    assert g["max_abs_dlogp"] == pytest.approx(abs(k5 - p5), abs=1e-5)
    for side, want in (("worst_kernel", k5), ("worst_plain", p5)):
        e = g[side]
        if want != -40.0:
            assert (e["row"], e["cls"], e["logit_fp32"]) == (0, 5, -40.0)
            assert e["logit"] == float(np.float32(want))
    assert (g["failed"] is None) is ok
    assert ("past the kernel-vs-plain rule" in TOOL.gate_line(g)) is \
        (not vs_plain_ok)


def test_items_without_fp32_take_the_kernel_vs_plain_rule():
    """Two loads of one route (chip_smoke's phase 6b: a Transcriber from
    the .pt files vs the anchor's) have no fp32 forward: every |d log p|
    <= 0.25."""
    for edits, ok in ((((7, -20.125), (0, 10.0625)), True),
                      (((5, -39.75), (0, 9.9375)), False)):
        g = TOOL.logp_gate([_routes(edits)])
        assert g["rule"] == "kernel_vs_plain" and "d_k" not in g
        assert g["ok"] is g["kernel_vs_plain_ok"] is ok
        assert g["failed"] == g["kernel_vs_plain_failed"]
        assert TOOL.gate_line(g).startswith("max|d log p|")


def test_each_side_held_to_its_own_fp32():
    """Eight arrays: the plain side's own fp32 forward (another package's),
    each route's distance taken from its own."""
    k = _three(-39.8, -40.0)
    p = _three(-40.0, -40.25)
    g = TOOL.logp_gate([k + (p[4], p[5])])
    assert g["d_k"] == pytest.approx(0.2, abs=1e-5)
    assert g["d_p"] == 0.0 and g["ok"]
    shifted = (k[4], k[5] - 0.3)            # a row shift: log p unchanged
    g = TOOL.logp_gate([k + shifted])
    assert g["d_p"] == pytest.approx(0.0, abs=1e-5)
    assert g["worst_kernel"]["logit_fp32"] == -40.0
    assert g["worst"]["logit_fp32_ref"] == pytest.approx(-40.3, abs=1e-5)


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


# faults injected into the kernel route on the splits named: ("logit", m)
# moves its logit at frame 0, class 1 (-80 on every route) by m; ("block",
# a) scales its fused repeat block's output by a (the narrow model's one
# fused block, through quartznet.fused_repeat_block, which only the kernel
# route calls). The gate records both splits and raises on the held-out
# one alone
@pytest.mark.parametrize("fault,splits,raises", [
    (None, (), False),
    (("logit", 0.125), ("heldout", "traindist"), False),
    (("logit", 0.5), ("heldout", "traindist"), True),
    (("logit", 0.5), ("traindist",), False),
    (("block", 4.0), ("heldout",), True)],
    ids=["0.0-splits0-False", "0.125-splits1-False", "0.5-splits2-True",
         "0.5-splits3-False", "block-splits4-True"])
def test_phase_eval_records_and_raises_on_the_gate(tmp_path, monkeypatch,
                                                   fault, splits, raises):
    from vietasr_tpu_torch.models import quartznet as qn

    work = str(tmp_path)
    config = _narrow_run(work)
    with_logits, calls = TOOL.with_logits, []
    kind, size = fault or (None, 0.0)

    def split():
        # route_divergence's calls: 3 a clip (kernel, plain, fp32), the 8
        # held-out clips first
        return "heldout" if len(calls) < 24 else "traindist"

    def moved(fn, *args, **kwargs):
        (lp, el), lg = with_logits(fn, *args, **kwargs)
        tr = fn.__self__
        kernel = tr.opts.block_impl != "plain"
        calls.append((split(), "kernel" if kernel else
                      "fp32" if tr.compute_dtype is None else "plain"))
        lg = lg.copy()
        lg[0, 0, 1] = -80.0
        if kind == "logit" and kernel and calls[-1][0] in splits:
            lg[0, 0, 1] += size
        return (_log_softmax(lg), el), lg

    fused = qn.fused_repeat_block

    def faulty(*args, **kwargs):
        out = fused(*args, **kwargs)
        return out * size if kind == "block" and split() in splits else out

    monkeypatch.setattr(TOOL, "with_logits", moved)
    monkeypatch.setattr(qn, "fused_repeat_block", faulty)
    monkeypatch.setattr(TOOL, "_streaming_decode", lambda *a, **k: None)
    art = str(tmp_path / "art")
    if raises:
        with pytest.raises(RuntimeError, match=r"held-out: .*FAILED"):
            TOOL.phase_eval(work, config, "g", device="cpu", art_dir=art)
        with open(os.path.join(art, "torch_synth_g.json")) as f:
            out = json.load(f)
    else:
        out = TOOL.phase_eval(work, config, "g", device="cpu", art_dir=art)
    assert [c[1] for c in calls] == ["kernel", "plain", "fp32"] * 16
    assert [c[0] for c in calls] == ["heldout"] * 24 + ["traindist"] * 24
    for split_ in ("heldout", "traindist"):
        c = out["kernel_route"][split_]
        g = c["gate"]
        assert set(g) >= {"ok", "failed", "tol", "max_abs_dlogp",
                          "max_row_dlogz", "max_abs_logit", "past_tol",
                          "max_steps_past_tol", "worst", "entries", "d_k",
                          "d_p", "bar", "kernel_vs_plain_ok"}
        assert (c["max_abs_dlogp"], c["tol"]) == (g["max_abs_dlogp"], 0.25)
        assert (c["d_k"], c["d_p"], c["bar"]) == (g["d_k"], g["d_p"],
                                                  g["bar"])
        assert c["tf32"] == TOOL.tf32_flags()
        assert len(c["blocks"]) == 3 and c["head"]
        hit = split_ in splits
        if kind != "block" or not hit:
            assert c["transcripts_equal"] == 8
        # off the faults the kernel route is the plain route (the kernel's
        # plain version on the CPU): d_k == d_p, the narrow model's bf16
        # noise
        if not hit or kind is None:
            assert g["ok"] and g["d_k"] == g["d_p"] < 0.05
            assert g["max_abs_dlogp"] == 0.0
            assert c["blocks"][1]["kernel_vs_plain"]["max_abs"] == 0.0
        elif kind == "logit":
            # every clip's frame 0 moved: 8 entries, the rest equal
            assert g["max_abs_dlogp"] == pytest.approx(size, abs=1e-5)
            assert g["past_tol"] == (8 if size > 0.25 else 0)
            assert g["d_k"] == pytest.approx(size, abs=0.05)
            assert g["ok"] is (size <= 0.25)
            w = g["worst"]
            assert (w["row"], w["cls"], w["logit_ref"]) == (0, 1, -80.0)
            assert (w["ulp"], w["steps"]) == (0.5, size / 0.5)
            assert c["worst_at_logp"] == w["logp_ref"]
        else:
            # the scaled block's output leaves fp32 and the plain route
            assert not g["ok"] and g["d_k"] > max(0.25, 1.5 * g["d_p"])
            assert c["blocks"][1]["kernel_vs_plain"]["max_abs"] > 0
            assert c["blocks"][0]["kernel_vs_plain"]["max_abs"] == 0
            assert c["first_block_past_one_step"] == 1
