"""vietasr_tpu_torch's training extras (train/freeze.py, LAMB and LARC in
train/optim.py, value schedules and the profiler hook in train/loop.py)
vs the JAX package's, on the CPU.

Tolerances, each with its reason:
- optimizers on seeded trees over 5 steps: 1e-6 relative (the same fp32
  formulas; XLA may fuse a multiply-add that PyTorch rounds twice).
- value schedules: 1e-6 relative.
- 5 narrow train steps with freezing: loss 1e-5 relative and parameters
  1e-6 absolute each step, what tests/test_torch_train.py holds one train
  step to (Novograd moves a parameter by ~lr per step, each step's error
  ~lr times the gradient's relative error).
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vietasr_tpu.config import BlockConfig as JaxBlock
from vietasr_tpu.config import DataConfig as JaxData
from vietasr_tpu.config import EncoderConfig as JaxEncoder
from vietasr_tpu.config import ModelConfig as JaxModel
from vietasr_tpu.config import SpecAugmentConfig as JaxSpecAug
from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeat
from vietasr_tpu.models.quartznet import init_quartznet as jax_init
from vietasr_tpu.train import TrainState as JaxState
from vietasr_tpu.train import make_optimizer as jax_make_optimizer
from vietasr_tpu.train import make_schedule as jax_make_schedule
from vietasr_tpu.train import make_train_step as jax_make_train_step
from vietasr_tpu_torch.config import (BlockConfig, EncoderConfig,
                                      ModelConfig, SpecAugmentConfig)
from vietasr_tpu_torch.frontend.features import FeaturizerConfig
from vietasr_tpu_torch.models.convert import to_numpy, train_state_from_jax
from vietasr_tpu_torch.models.quartznet import (init_quartznet, tree_leaves,
                                                tree_paths)
from vietasr_tpu_torch.train import (TrainState, Trainer, make_optimizer,
                                     make_schedule, make_train_step)
from vietasr_tpu_torch.train.freeze import (freeze, make_value_schedule,
                                            unfreeze_schedule)
from vietasr_tpu_torch.train.loop import batch_to_tensors
from vietasr_tpu_torch.train.synthetic import SyntheticToneDataset
from vietasr_tpu_torch.utils import tracing

# the package's `freeze` function shadows its module of that name
jax_freeze = importlib.import_module("vietasr_tpu.train.freeze")

torch.set_num_threads(1)

LABELS = [" ", "a", "b", "c"]
BLOCKS = [dict(filters=32, kernel=11, stride=2, residual=False,
               separable=True),
          dict(filters=32, kernel=9, stride=1, residual=True, separable=True),
          dict(filters=48, kernel=1, stride=1, residual=False,
               separable=False)]


def _configs():
    feat = dict(features=16, dither=0.0, pad_to=8)
    jax_cfg = JaxModel(name="narrow", labels=LABELS,
                       featurizer=JaxFeat(**feat),
                       encoder=JaxEncoder(blocks=tuple(JaxBlock(**b)
                                                       for b in BLOCKS),
                                          feat_in=16),
                       spec_augment=JaxSpecAug(), data=JaxData())
    port_cfg = ModelConfig(name="narrow", labels=LABELS,
                           featurizer=FeaturizerConfig(**feat),
                           encoder=EncoderConfig(blocks=tuple(
                               BlockConfig(**b) for b in BLOCKS), feat_in=16),
                           spec_augment=SpecAugmentConfig())
    return jax_cfg, port_cfg


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _max_diff(jax_tree, port_tree):
    port_np = to_numpy(port_tree)
    return max(float(np.abs(np.asarray(_at(port_np, path)) - want).max())
               for path, want in jax.tree_util.tree_leaves_with_path(
                   jax.tree_util.tree_map(np.asarray, jax_tree)))


# ---------------------------------------------------------------------------
# optimizers on seeded trees


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"encoder": [{"w": rng.randn(4, 3).astype(np.float32),
                         "b": rng.randn(3).astype(np.float32)},
                        {"w": rng.randn(3, 3).astype(np.float32)}],
            "decoder": {"w": rng.randn(3, 2).astype(np.float32),
                        "z": np.zeros(2, np.float32)}}


def _run_both(jax_opt, port_factory, steps=5, seed=0):
    """The same gradients into an optax transformation and a port
    optimizer built as TrainState.create builds it (one group with the
    parameters' paths). Returns (jax params, port params tree)."""
    w0 = _tree(seed)
    rng = np.random.RandomState(seed + 1)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 3).astype(np.float32), w0)
        for _ in range(steps)]
    params = jax.tree_util.tree_map(jnp.asarray, w0)
    state = jax_opt.init(params)
    for g in grads:
        updates, state = jax_opt.update(
            jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    tensors = jax.tree_util.tree_map(
        lambda a: torch.tensor(a, requires_grad=True), w0)
    leaves = tree_leaves(tensors)
    opt = port_factory([{"params": leaves, "paths": tree_paths(tensors)}])
    for g in grads:
        for p, gl in zip(leaves, tree_leaves(g)):
            p.grad = torch.from_numpy(gl)
        opt.step()
    return params, tensors


def _close(want, got, rtol=1e-6):
    got_np = to_numpy(got)
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, want)):
        np.testing.assert_allclose(np.asarray(_at(got_np, path)), w,
                                   rtol=rtol, atol=rtol, err_msg=str(path))


SCHED = ("CosineAnnealing", 0.05, 8)


@pytest.mark.parametrize("name,kw", [
    ("lamb", {}), ("lamb", dict(weight_decay=0.01)),
    ("lamb", dict(weight_decay=0.01, grad_clip_norm=2.0)),
    ("sgd", dict(larc=True)), ("sgd", dict(larc=True, weight_decay=0.01)),
    ("sgd", dict(larc=True, larc_eta=0.5, grad_clip_norm=2.0)),
], ids=["lamb", "lamb_wd", "lamb_wd_clip", "larc", "larc_wd",
        "larc_eta_clip"])
def test_lamb_and_larc_match_optax(name, kw):
    """5 steps on a tree with a zero-norm leaf (trust ratio 1 there), under
    a warmup-cosine schedule."""
    want, got = _run_both(
        jax_make_optimizer(name, jax_make_schedule(*SCHED, warmup_steps=2),
                           **kw),
        make_optimizer(name, make_schedule(*SCHED, warmup_steps=2), **kw))
    _close(want, got)


@pytest.mark.parametrize("name", ["novograd", "adamw", "lamb", "sgd"])
def test_freeze_matches_optax(name):
    """Frozen leaves do not move and the inner optimizer holds no state for
    them (their weight decay stops; a clip sees the trained leaves only)."""
    kw = dict(weight_decay=0.01, grad_clip_norm=3.0)
    prefixes = ["encoder/0", "decoder/z"]
    want, got = _run_both(
        jax_freeze.freeze(jax_make_optimizer(name, 0.05, **kw), prefixes),
        freeze(make_optimizer(name, 0.05, **kw), prefixes))
    _close(want, got)
    w0 = _tree(0)
    assert np.array_equal(got["encoder"][0]["w"].detach().numpy(),
                          w0["encoder"][0]["w"])
    opt = freeze(make_optimizer(name, 0.05, **kw), prefixes)(
        [{"params": tree_leaves(got), "paths": tree_paths(got)}])
    assert len(opt.param_groups[0]["params"]) == 2
    assert sorted(opt.param_groups[0]["paths"]) == ["decoder/w",
                                                    "encoder/1/w"]


@pytest.mark.parametrize("name", ["novograd", "adam", "lamb"])
def test_unfreeze_schedule_matches_optax(name):
    """The encoder thaws at step 3, encoder/1 at step 4: gradients gated
    before the inner optimizer (clip included), updates after it."""
    at = {"encoder/1": 4, "encoder": 3}
    kw = dict(weight_decay=0.01, grad_clip_norm=3.0)
    want, got = _run_both(
        jax_freeze.unfreeze_schedule(jax_make_optimizer(name, 0.05, **kw),
                                     at),
        unfreeze_schedule(make_optimizer(name, 0.05, **kw), at), steps=5)
    _close(want, got)
    for steps, moved in ((3, False), (4, True)):
        _, early = _run_both(optax.identity(), unfreeze_schedule(
            make_optimizer(name, 0.05), at), steps=steps)
        assert np.array_equal(early["encoder"][0]["w"].detach().numpy(),
                              _tree(0)["encoder"][0]["w"]) != moved


def test_freeze_needs_paths():
    w = torch.ones(3, requires_grad=True)
    for wrap in (lambda f: freeze(f, ["encoder"]),
                 lambda f: unfreeze_schedule(f, {"encoder": 2})):
        with pytest.raises(ValueError, match="paths"):
            wrap(make_optimizer("sgd", 0.1))([w])


@pytest.mark.parametrize("policy,args", [
    ("linear", (2.0, 0.0, 10)), ("exp", (1.0, 1e-3, 8)),
    ("exponential", (0.5, 4.0, 6)), ("linear", (0.0, 5.0, 3))])
def test_value_schedules_match_jax(policy, args):
    want = jax_freeze.make_value_schedule(policy, *args, warmup_steps=2)
    got = make_value_schedule(policy, *args, warmup_steps=2)
    for step in range(14):
        np.testing.assert_allclose(
            float(got(torch.tensor(step, dtype=torch.int32))),
            float(want(jnp.asarray(step, jnp.int32))), rtol=1e-6,
            err_msg=f"step {step}")
    with pytest.raises(ValueError):
        make_value_schedule("cosine", 1.0, 0.0, 5)


# ---------------------------------------------------------------------------
# train steps


def _jax_variables(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_init(
        jax.random.PRNGKey(seed), cfg.encoder, cfg.num_classes))


SCHEDULES = {"specaug_freq_masks": ("linear", 2.0, 0.0, 4),
             "blank_scale": ("exp", 1.0, 0.1, 5)}


@pytest.mark.parametrize("wrap", ["freeze", "unfreeze"])
def test_train_steps_with_freezing_match_jax(wrap):
    """5 narrow train steps (fp32, Novograd) with encoder/0 frozen, or the
    encoder thawing at step 3, and two value schedules reported in the
    metrics: loss, parameters and the scheduled values each step."""
    jax_cfg, port_cfg = _configs()
    variables = _jax_variables(jax_cfg)
    if wrap == "freeze":
        jw = lambda o: jax_freeze.freeze(o, ["encoder/0"])  # noqa: E731
        pw = lambda o: freeze(o, ["encoder/0"])             # noqa: E731
    else:
        jw = lambda o: jax_freeze.unfreeze_schedule(         # noqa: E731
            o, {"encoder": 3})
        pw = lambda o: unfreeze_schedule(o, {"encoder": 3})  # noqa: E731
    jax_opt = jw(jax_make_optimizer("novograd", 0.01, weight_decay=0.001))
    jax_sched = {k: jax_freeze.make_value_schedule(*v)
                 for k, v in SCHEDULES.items()}
    step = jax.jit(jax_make_train_step(jax_cfg, jax_opt, use_specaug=False,
                                       ctc_impl="pallas_interpret",
                                       value_schedules=jax_sched))
    jax_state = JaxState.create(variables, jax_opt)
    state = train_state_from_jax(variables, optimizer=pw(make_optimizer(
        "novograd", 0.01, weight_decay=0.001)), device="cpu")
    port_step = make_train_step(
        port_cfg, use_specaug=False, ctc_impl="kernel", device="cpu",
        value_schedules={k: make_value_schedule(*v)
                         for k, v in SCHEDULES.items()})
    data = SyntheticToneDataset(seed=3)
    enc0 = state.params["encoder"][0]["sub"][0]["pw_w"].detach().clone()
    for i in range(5):
        batch = data.batch(4)
        jax_state, jax_m = step(jax_state, {
            k: jnp.asarray(getattr(batch, k))
            for k in ("signal", "signal_lens", "tokens", "token_lens")},
            jax.random.PRNGKey(i))
        state, m = port_step(state, batch_to_tensors(batch, "cpu"), None)
        np.testing.assert_allclose(float(m["loss"]), float(jax_m["loss"]),
                                   rtol=1e-5)
        for k in SCHEDULES:
            np.testing.assert_allclose(float(m[k]), float(jax_m[k]),
                                       rtol=1e-6)
        assert _max_diff(jax_state.params, state.params) <= 1e-6, i
        moved = not torch.equal(
            state.params["encoder"][0]["sub"][0]["pw_w"].detach(), enc0)
        assert moved == (wrap == "unfreeze" and i >= 3), i
    assert int(state.skipped_steps) == 0


def test_specaug_schedule_drives_the_band_counts():
    """With the frequency and time band counts scheduled to 0 the SpecAugment
    step computes the loss of no masking; at the config's counts it masks."""
    _, cfg = _configs()
    import dataclasses

    cfg = dataclasses.replace(cfg, spec_augment=SpecAugmentConfig(
        freq_masks=2, time_masks=2, freq_width=6, time_width=8))
    variables = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                               cfg.num_classes, device="cpu")
    batch = batch_to_tensors(SyntheticToneDataset(seed=1).batch(2), "cpu")
    zero = make_value_schedule("linear", 0.0, 0.0, 1)
    losses = {}
    for key, specaug, sched in (("none", False, None),
                                ("zero", True, {"specaug_freq_masks": zero,
                                                "specaug_time_masks": zero}),
                                ("full", True, None)):
        state = TrainState.create(variables, make_optimizer("sgd", 0.0))
        step = make_train_step(cfg, use_specaug=specaug, device="cpu",
                               value_schedules=sched)
        _, m = step(state, batch, torch.Generator().manual_seed(5))
        losses[key] = float(m["loss"])
        if sched:
            assert float(m["specaug_time_masks"]) == 0.0
    assert losses["zero"] == losses["none"] != losses["full"]


def test_profiler_traces_only_the_asked_steps(tmp_path):
    _, cfg = _configs()
    variables = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                               cfg.num_classes, device="cpu")
    state = TrainState.create(variables, make_optimizer("sgd", 1e-3))
    tr = Trainer(cfg, use_specaug=False, log_every=0, device="cpu",
                 prefetch_depth=0, profile_dir=str(tmp_path / "prof"),
                 profile_start=1, profile_stop=3)
    tr.fit(state, [SyntheticToneDataset(seed=2).batch(2)] * 5)
    files = os.listdir(tmp_path / "prof")
    assert files == ["trace_steps_1_3.json"]
    with open(tmp_path / "prof" / files[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    # steps 1 and 2, as the file's name says: the window's session holds
    # them, the three steps outside it ran untraced
    assert names.count("vietasr.train.step") == 2
    assert not any(n and n.startswith("train_step_") for n in names)
    assert tracing.summary()["train.step"]["n"] == 2
    assert int(state.step) == 5


def _step_ranges(prof, path):
    """{index of a `vietasr.train.step` range: names of the program's
    ranges inside it} and the names of the ranges at the top, in order."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        ev = sorted((e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X"
                     and e["name"].startswith(tracing.PREFIX)),
                    key=lambda e: (e["ts"], -e["dur"]))
    steps = [e for e in ev if e["name"] == "vietasr.train.step"]
    inside, top = {}, []
    for e in ev:
        around = [i for i, st in enumerate(steps) if st is not e
                  and st["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= st["ts"] + st["dur"]]
        if around:
            inside.setdefault(around[0], []).append(
                e["name"][len(tracing.PREFIX):])
        else:
            top.append(e["name"][len(tracing.PREFIX):])
    return inside, top


def test_trainer_spans_and_counters_on_a_fit(tmp_path):
    """Under a profiler, each step's parts are ranges inside its
    `train.step`, each microbatch one `train.forward_backward`; the batch
    waits lie between the steps; the counters sum the batches."""
    _, cfg = _configs()
    variables = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                               cfg.num_classes, device="cpu")
    state = TrainState.create(variables, make_optimizer("novograd", 1e-3))
    tr = Trainer(cfg, use_specaug=False, log_every=2, device="cpu",
                 prefetch_depth=2, grad_accum=2)
    batches = [SyntheticToneDataset(seed=2).batch(4) for _ in range(3)]
    batches[1].signal_lens[3] = 4000
    with tracing.span("between"):          # the last session ends
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.fit(state, batches)
    inside, top = _step_ranges(prof, tmp_path / "fit.json")
    assert top == ["train.batch_wait", "train.step"] * 3 \
        + ["train.batch_wait"]
    part = ["train.upload", "train.forward_backward",
            "train.forward_backward", "train.optimizer"]
    assert inside == {0: part, 1: part + ["train.log_read"], 2: part}
    s = tracing.summary()
    assert s["train.step"]["n"] == 3 and s["train.batch_wait"]["n"] == 4
    assert s["train.forward_backward"]["n"] == 6
    signal = sum(int(b.signal_lens.sum()) for b in batches)
    size = sum(b.signal.size for b in batches)
    assert (s["train.steps"], s["train.rows"], s["train.signal_samples"],
            s["train.padded_samples"]) == (3, 12, signal, size - signal)
    assert int(state.step) == 3


def test_profile_window_open_at_the_end_of_fit_is_written(tmp_path):
    """A fit with fewer steps than profile_stop stops its profiler and
    writes the steps it traced; no span records after fit."""
    _, cfg = _configs()
    variables = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                               cfg.num_classes, device="cpu")
    state = TrainState.create(variables, make_optimizer("sgd", 1e-3))
    tr = Trainer(cfg, use_specaug=False, log_every=0, device="cpu",
                 prefetch_depth=0, profile_dir=str(tmp_path / "prof"),
                 profile_start=1, profile_stop=10)
    tr.fit(state, [SyntheticToneDataset(seed=2).batch(2)] * 3)
    assert not torch.autograd._profiler_enabled()
    assert tr._profiler is None
    assert os.listdir(tmp_path / "prof") == ["trace_steps_1_3.json"]
    with open(tmp_path / "prof" / "trace_steps_1_3.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("vietasr.train.step") == 2
    assert not tracing.enabled()
    with tracing.span("after"):
        pass
    assert "after" not in tracing.summary()


def test_a_failed_fit_stops_its_profile_window_and_writes_nothing(
        tmp_path):
    """fit raising inside an open window stops the profiler without a
    synchronize or an export, and raises the step's own error."""
    _, cfg = _configs()
    variables = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                               cfg.num_classes, device="cpu")
    state = TrainState.create(variables, make_optimizer("sgd", 1e-3))
    tr = Trainer(cfg, use_specaug=False, log_every=0, device="cpu",
                 prefetch_depth=0, profile_dir=str(tmp_path / "prof"),
                 profile_start=0, profile_stop=10)
    step = tr._train_step

    def fails_at_two(state, batch, generator):
        if int(state.step) == 2:
            raise RuntimeError("the step failed")
        return step(state, batch, generator)

    tr._train_step = fails_at_two
    with pytest.raises(RuntimeError, match="the step failed"):
        tr.fit(state, [SyntheticToneDataset(seed=2).batch(2)] * 4)
    assert not torch.autograd._profiler_enabled()
    assert tr._profiler is None
    assert not os.path.exists(tmp_path / "prof")


def test_trainer_value_schedules_reach_the_metrics():
    _, cfg = _configs()
    variables = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                               cfg.num_classes, device="cpu")
    state = TrainState.create(variables, make_optimizer("sgd", 1e-3))
    tr = Trainer(cfg, use_specaug=False, log_every=1, device="cpu",
                 prefetch_depth=0, value_schedules={
                     "x": make_value_schedule("linear", 1.0, 0.0, 4)})
    tr.fit(state, [SyntheticToneDataset(seed=2).batch(2)] * 3)
    assert [h["x"] for h in tr.history if "x" in h] \
        == pytest.approx([1.0, 0.75, 0.5])
