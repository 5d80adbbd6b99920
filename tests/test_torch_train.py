"""vietasr_tpu_torch's training path (models/layers.py training half,
models/quartznet.py init + training mode, ops/specaug.py,
train/{schedules,optim,state,loop,checkpoint,metrics,synthetic}.py,
models/convert.py train_state_from_jax) vs the JAX package's, on the CPU,
on the same seeded numpy inputs and weights.

Tolerances, each with its reason:
- BN, schedules, optimizers: 1e-6 relative (the same fp32 formulas; XLA
  may fuse a multiply-add that PyTorch rounds twice).
- SpecAugment / cutout: equal masks (the same uniforms, floor and compare).
- A train step (narrow QuartzNet, fp32): loss 1e-5 relative, grad norm
  1e-5 relative, params 1e-6 absolute, BN stats 1e-6 relative. Forward and
  backward sum in another order over 3 blocks (measured ~3e-7 loss, ~1e-7
  params); Novograd normalizes the gradient per tensor, so a parameter
  moves by ~lr and its error is ~lr times the gradient's relative error.
- Full width from the anchor (15 blocks, 5.1M params): loss 1e-5
  relative, grad norm 1e-4 relative (fp32 sums over 15 blocks of up to
  1,024 channels, in another order; measured 2e-7 and 9e-6).
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vietasr_tpu.config import BlockConfig as JaxBlock
from vietasr_tpu.config import DataConfig as JaxData
from vietasr_tpu.config import EncoderConfig as JaxEncoder
from vietasr_tpu.config import ModelConfig as JaxModel
from vietasr_tpu.config import SpecAugmentConfig as JaxSpecAug
from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeat
from vietasr_tpu.models.layers import batchnorm_apply as jax_bn
from vietasr_tpu.models.quartznet import init_quartznet as jax_init
from vietasr_tpu.ops import specaug as jax_specaug
from vietasr_tpu.train import CheckpointManager as JaxCheckpoints
from vietasr_tpu.train import TrainState as JaxState
from vietasr_tpu.train import make_optimizer as jax_make_optimizer
from vietasr_tpu.train import make_schedule as jax_make_schedule
from vietasr_tpu.train import make_train_step as jax_make_train_step
from vietasr_tpu.train.loop import make_eval_step as jax_make_eval_step
from vietasr_tpu.train.optim import novograd as jax_novograd
from vietasr_tpu_torch.audio import CharTokenizer
from vietasr_tpu_torch.config import (BlockConfig, EncoderConfig,
                                      ModelConfig, SpecAugmentConfig,
                                      load_config)
from vietasr_tpu_torch.frontend.features import FeaturizerConfig
from vietasr_tpu_torch.models.convert import (load_anchor,
                                              train_state_from_jax,
                                              to_numpy)
from vietasr_tpu_torch.models.layers import batchnorm_apply, dropout
from vietasr_tpu_torch.models.quartznet import (init_quartznet, map_tree,
                                                tree_leaves)
from vietasr_tpu_torch.ops import specaug
from vietasr_tpu_torch.train import (CheckpointManager, TrainState, Trainer,
                                     make_eval_step, make_optimizer,
                                     make_schedule, make_train_step)
from vietasr_tpu_torch.train.loop import BATCH_KEYS, batch_to_tensors
from vietasr_tpu_torch.train.metrics import levenshtein, word_error_rate
from vietasr_tpu_torch.train.synthetic import (SyntheticToneDataset,
                                               zeros_batch)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")

LABELS = [" ", "a", "b", "c"]
# a narrow QuartzNet with 12x1's three kinds of block: strided separable,
# residual separable, dense 1x1
BLOCKS = [dict(filters=32, kernel=11, stride=2, residual=False,
               separable=True),
          dict(filters=32, kernel=9, stride=1, residual=True, separable=True),
          dict(filters=48, kernel=1, stride=1, residual=False,
               separable=False)]


def _configs(dither=0.0):
    feat = dict(features=16, dither=dither, pad_to=8)
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


def _jax_variables(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_init(
        jax.random.PRNGKey(seed), cfg.encoder, cfg.num_classes))


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _max_diff(jax_tree, port_tree, relative=False):
    """Largest |d| (or |d| / max(1, |want|)) over every leaf of a JAX tree
    and the port tree at the same paths."""
    port_np = to_numpy(port_tree)
    worst = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jax_tree)):
        d = np.abs(np.asarray(_at(port_np, path)) - want).max()
        if relative:
            d = d / max(1.0, float(np.abs(want).max()))
        worst = max(worst, float(d))
    return worst


def _jax_arrays(batch):
    return {k: jnp.asarray(getattr(batch, k)) for k in BATCH_KEYS}


# ---------------------------------------------------------------------------
# layers, initializers


def test_batchnorm_training_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 17, 8) * 2 + 1).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "bias": rng.randn(8).astype(np.float32)}
    stats = {"mean": rng.randn(8).astype(np.float32),
             "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}  # noqa
    for training in (True, False):
        want, want_stats = jax_bn(jnp.asarray(x), params, stats,
                                  training=training)
        got, got_stats = batchnorm_apply(torch.from_numpy(x), t(params),
                                         t(stats), training=training)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_stats[k].numpy(),
                                       np.asarray(want_stats[k]), rtol=1e-6)


def test_init_quartznet_tree_and_distributions():
    """The same tree and shapes as JAX's init at full width (5,109,147
    params); xavier-uniform weights inside their bound with its variance."""
    cfg = load_config(CONFIG)
    gen = torch.Generator().manual_seed(0)
    got = init_quartznet(gen, cfg.encoder, cfg.num_classes, device="cpu")
    want = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0),
                                           jax_load_config(CONFIG).encoder,
                                           cfg.num_classes))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        assert tuple(_at(got, path).shape) == tuple(leaf.shape), path
    assert len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    assert sum(p.numel() for p in tree_leaves(got["params"])) == 5_109_147
    w = got["params"]["encoder"][3]["sub"][0]["pw_w"]       # (256, 256)
    bound = math.sqrt(6.0 / (256 + 256))
    assert float(w.abs().max()) <= bound
    assert abs(float(w.var()) - bound ** 2 / 3) < 0.05 * bound ** 2 / 3
    again = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                           cfg.num_classes, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(again)))


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(1)
    y = dropout(x, 0.2, gen, training=True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert torch.equal(dropout(x, 0.2, gen, training=False), x)


# ---------------------------------------------------------------------------
# SpecAugment


def _spec_cfgs():
    return (JaxSpecAug(freq_masks=2, time_masks=3, freq_width=7,
                       time_width=9, rect_masks=2, rect_time=6, rect_freq=5),
            SpecAugmentConfig(freq_masks=2, time_masks=3, freq_width=7,
                              time_width=9, rect_masks=2, rect_time=6,
                              rect_freq=5))


def _jax_band_draws(key, b, n):
    r_start, r_width = jax.random.split(key)
    return [np.array(jax.random.uniform(r_start, (b, n))),
            np.array(jax.random.uniform(r_width, (b, n)))]


def _jax_augment_draws(key, b, cfg):
    r_f, r_t = jax.random.split(key)
    return (_jax_band_draws(r_f, b, cfg.freq_masks)
            + _jax_band_draws(r_t, b, cfg.time_masks))


def _jax_cutout_draws(key, b, cfg):
    return [np.array(jax.random.uniform(k, (b, cfg.rect_masks)))
            for k in jax.random.split(key, 4)]


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_augment_and_cutout_masks_match_jax(seed):
    """Fed JAX's own uniforms, the port zeroes exactly the same cells, for
    each transform alone and for both in the reference's order."""
    jcfg, pcfg = _spec_cfgs()
    x = np.random.RandomState(seed).randn(3, 60, 16).astype(np.float32) + 5
    key = jax.random.PRNGKey(seed)
    xt = torch.from_numpy(x)
    want = np.asarray(jax_specaug.spec_augment(key, jnp.asarray(x), jcfg))
    got = specaug.spec_augment(xt, pcfg, draws=[torch.from_numpy(d) for d in
                                                _jax_augment_draws(key, 3,
                                                                   jcfg)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()
    want = np.asarray(jax_specaug.spec_cutout(key, jnp.asarray(x), jcfg))
    got = specaug.spec_cutout(xt, pcfg, draws=[torch.from_numpy(d) for d in
                                               _jax_cutout_draws(key, 3,
                                                                 jcfg)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()
    r_c, r_a = jax.random.split(key)
    draws = _jax_cutout_draws(r_c, 3, jcfg) + _jax_augment_draws(r_a, 3, jcfg)
    want = np.asarray(jax_specaug.apply_spec_augment(key, jnp.asarray(x),
                                                     jcfg))
    got = specaug.apply_spec_augment(xt, pcfg, draws=[torch.from_numpy(d)
                                                      for d in draws])
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_augment_active_gates_and_generator():
    """The active_* gates keep bands i < active; the generator route draws
    reproducibly."""
    jcfg, pcfg = _spec_cfgs()
    x = np.ones((2, 50, 16), np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_specaug.spec_augment(key, jnp.asarray(x), jcfg,
                                               active_freq=1, active_time=0))
    got = specaug.spec_augment(
        torch.from_numpy(x), pcfg, active_freq=1, active_time=0,
        draws=[torch.from_numpy(d) for d in _jax_augment_draws(key, 2, jcfg)])
    np.testing.assert_array_equal(got.numpy(), want)
    a, b = (specaug.apply_spec_augment(
        torch.from_numpy(x), pcfg, generator=torch.Generator().manual_seed(3))
        for _ in range(2))
    assert torch.equal(a, b) and bool((a == 0).any())


# ---------------------------------------------------------------------------
# schedules, optimizers


POLICIES = ["CosineAnnealing", "WarmupAnnealing", "SquareAnnealing",
            "SquareRootAnnealing", "InverseSquareRootAnnealing",
            "PolynomialDecayAnnealing", "PolynomialHoldDecayAnnealing"]


@pytest.mark.parametrize("name", POLICIES)
def test_schedules_match_jax(name):
    kw = dict(warmup_steps=100, min_lr=1e-4)
    if name in ("CosineAnnealing", "PolynomialHoldDecayAnnealing"):
        kw["hold_steps"] = 50
    if name.startswith("Polynomial"):
        kw["power"] = 2.0
    want = jax_make_schedule(name, 0.02, 1000, **kw)
    got = make_schedule(name, 0.02, 1000, **kw)
    for step in (0, 99, 100, 120, 500, 999, 1000, 1001, 1500):
        np.testing.assert_allclose(float(got(step)), float(want(step)),
                                   rtol=1e-6, err_msg=f"step {step}")
        np.testing.assert_allclose(
            float(got(torch.tensor(step, dtype=torch.int32))),
            float(want(step)), rtol=1e-6)


def _run_both(jax_opt, port_factory, steps=5, seed=0):
    """The same gradients into both; returns (jax params, port params)."""
    rng = np.random.RandomState(seed)
    w0 = {"w": rng.randn(4, 3).astype(np.float32),
          "b": rng.randn(3).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 3).astype(np.float32)
              for k, v in w0.items()} for _ in range(steps)]
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    state = jax_opt.init(params)
    for g in grads:
        updates, state = jax_opt.update({k: jnp.asarray(v)
                                         for k, v in g.items()}, state,
                                        params)
        params = jax.tree_util.tree_map(jnp.add, params, updates)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in w0.items()}
    opt = port_factory([tensors["w"], tensors["b"]])
    for g in grads:
        for k in tensors:
            tensors[k].grad = torch.from_numpy(g[k])
        opt.step()
    return params, tensors


@pytest.mark.parametrize("kw", [dict(weight_decay=0.0),
                                dict(weight_decay=0.05),
                                dict(weight_decay=0.05, grad_averaging=True,
                                     luc=True, luc_trust=0.01)])
def test_novograd_matches_jax(kw):
    """Five Novograd steps under a warmup-cosine schedule (lr(step + 1))."""
    from vietasr_tpu_torch.train.optim import Novograd

    sched = ("CosineAnnealing", 0.05, 8)
    want, got = _run_both(
        jax_novograd(jax_make_schedule(*sched, warmup_steps=2), **kw),
        lambda p: Novograd(p, make_schedule(*sched, warmup_steps=2), **kw))
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", [("adam", {}),
                                     ("adamw", dict(weight_decay=0.01)),
                                     ("sgd", {}),
                                     ("sgd", dict(weight_decay=0.01)),
                                     ("novograd", dict(grad_clip_norm=2.0))])
def test_make_optimizer_matches_jax(name, kw):
    """Each optimizer of the reference set against its optax chain, with a
    schedule (optax evaluates it at the update count)."""
    sched = ("CosineAnnealing", 0.05, 8)
    want, got = _run_both(
        jax_make_optimizer(name, jax_make_schedule(*sched, warmup_steps=2),
                           **kw),
        make_optimizer(name, make_schedule(*sched, warmup_steps=2), **kw))
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_guarded_step_keeps_everything_when_not_finite():
    w = torch.ones(3, requires_grad=True)
    opt = make_optimizer("novograd", 0.1)([w])
    w.grad = torch.full((3,), 2.0)
    opt.step(finite=torch.tensor(True))
    before = (w.detach().clone(), opt.state[w]["exp_avg"].clone(),
              opt.param_groups[0]["step"].clone())
    opt.step(finite=torch.tensor(False))
    assert torch.equal(w.detach(), before[0])
    assert torch.equal(opt.state[w]["exp_avg"], before[1])
    assert int(opt.param_groups[0]["step"]) == int(before[2]) == 1


# ---------------------------------------------------------------------------
# train step vs JAX


def _step_pair(batch, *, grad_accum=1, opt=("novograd", 0.01, 0.001)):
    """One train step in each package from the same JAX-initialised
    state: JAX with the Pallas CTC pair in interpret mode, the port with
    its kernel route (the pair's plain versions on the CPU)."""
    jax_cfg, port_cfg = _configs()
    variables = _jax_variables(jax_cfg)
    name, lr, wd = opt
    jax_opt = jax_make_optimizer(name, lr, weight_decay=wd)
    step = jax.jit(jax_make_train_step(jax_cfg, jax_opt, use_specaug=False,
                                       grad_accum=grad_accum,
                                       ctc_impl="pallas_interpret"))
    jax_state, jax_m = step(JaxState.create(variables, jax_opt),
                            _jax_arrays(batch), jax.random.PRNGKey(0))
    state = train_state_from_jax(variables, optimizer=make_optimizer(
        name, lr, weight_decay=wd), device="cpu")
    port_step = make_train_step(port_cfg, use_specaug=False,
                                grad_accum=grad_accum, ctc_impl="kernel",
                                device="cpu")
    state, m = port_step(state, batch_to_tensors(batch, "cpu"), None)
    return variables, (jax_state, jax_m), (state, m)


def _check_step(pair):
    _, (jax_state, jax_m), (state, m) = pair
    np.testing.assert_allclose(float(m["loss"]), float(jax_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jax_m["grad_norm"]), rtol=1e-5)
    assert _max_diff(jax_state.params, state.params) <= 1e-6
    assert _max_diff(jax_state.batch_stats, state.batch_stats,
                     relative=True) <= 1e-6
    assert int(state.skipped_steps) == int(jax_state.skipped_steps)
    assert int(state.step) == int(jax_state.step) == 1


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    batch = SyntheticToneDataset(seed=0).batch(4)
    pair = _step_pair(batch, grad_accum=grad_accum)
    _check_step(pair)
    assert int(pair[2][0].skipped_steps) == 0


def test_train_step_infeasible_row_masked_not_skipped():
    batch = SyntheticToneDataset(seed=1).batch(4)
    batch.signal_lens[0] = 320                    # 2 frames for 3 labels
    pair = _step_pair(batch, opt=("sgd", 0.01, 0.0))
    _check_step(pair)
    variables, _, (state, m) = pair
    assert int(state.skipped_steps) == 0 and float(m["loss"]) < 1e25
    assert not np.array_equal(
        to_numpy(state.params)["encoder"][0]["sub"][0]["dw_w"],
        variables["params"]["encoder"][0]["sub"][0]["dw_w"])


def test_train_step_nan_is_skipped():
    batch = SyntheticToneDataset(seed=2).batch(4)
    batch.signal[0, 0] = np.nan
    variables, (jax_state, jax_m), (state, m) = _step_pair(
        batch, opt=("sgd", 0.01, 0.0))
    assert int(jax_state.skipped_steps) == int(state.skipped_steps) == 1
    assert not np.isfinite(float(m["grad_norm"]))
    assert not np.isfinite(float(jax_m["grad_norm"]))
    assert _max_diff(variables["params"], state.params) == 0.0
    assert _max_diff(variables["batch_stats"], state.batch_stats) == 0.0
    assert int(state.optimizer.param_groups[0]["step"]) == 0


def test_eval_step_matches_jax():
    jax_cfg, port_cfg = _configs()
    variables = _jax_variables(jax_cfg, seed=3)
    batch = SyntheticToneDataset(seed=3).batch(3)
    want = jax.jit(jax_make_eval_step(jax_cfg))(
        variables["params"], variables["batch_stats"], _jax_arrays(batch))
    state = train_state_from_jax(variables, optimizer=make_optimizer(
        "sgd", 0.1), device="cpu")
    got = make_eval_step(port_cfg, device="cpu")(
        state.params, state.batch_stats, batch_to_tensors(batch, "cpu"))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for k in ("preds", "keep", "enc_lens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_state_from_jax_carries_novograd_state():
    """JAX takes a step; its state (params, stats, Novograd moments and
    count) crosses over, and the next step agrees in both packages."""
    jax_cfg, port_cfg = _configs()
    variables = _jax_variables(jax_cfg, seed=4)
    sched = jax_make_schedule("CosineAnnealing", 0.02, 10, warmup_steps=3)
    jax_opt = jax_novograd(sched, weight_decay=0.001)
    step = jax.jit(jax_make_train_step(jax_cfg, jax_opt, use_specaug=False,
                                       ctc_impl="pallas_interpret"))
    data = SyntheticToneDataset(seed=4)
    b1, b2 = data.batch(4), data.batch(4)
    s1, _ = step(JaxState.create(variables, jax_opt), _jax_arrays(b1),
                 jax.random.PRNGKey(0))
    s2, jax_m = step(s1, _jax_arrays(b2), jax.random.PRNGKey(1))
    s1_np = jax.tree_util.tree_map(np.asarray, s1)
    state = train_state_from_jax(
        {"params": s1_np.params, "batch_stats": s1_np.batch_stats},
        s1_np.opt_state, step=1, device="cpu",
        optimizer=make_optimizer("novograd", make_schedule(
            "CosineAnnealing", 0.02, 10, warmup_steps=3),
            weight_decay=0.001))
    state, m = make_train_step(port_cfg, use_specaug=False,
                               ctc_impl="kernel", device="cpu")(
        state, batch_to_tensors(b2, "cpu"), None)
    np.testing.assert_allclose(float(m["loss"]), float(jax_m["loss"]),
                               rtol=1e-5)
    assert _max_diff(s2.params, state.params) <= 1e-6
    assert int(state.optimizer.param_groups[0]["step"]) == 2
    with pytest.raises(TypeError):
        train_state_from_jax(variables, s1_np.opt_state, device="cpu",
                             optimizer=make_optimizer("sgd", 0.1))


def test_full_width_train_step_from_anchor():
    """The slice as a whole: one fp32 train step of QuartzNet12x1_vi from
    the anchor's unfolded tree, B = 2 x 1 s, CTC through the kernel pair's
    route (JAX: the Pallas pair in interpret mode)."""
    jax_cfg = jax_load_config(CONFIG)
    jax_cfg = dataclasses.replace(jax_cfg, featurizer=dataclasses.replace(
        jax_cfg.featurizer, dither=0.0))
    port_cfg = load_config(CONFIG)
    port_cfg = dataclasses.replace(port_cfg, featurizer=dataclasses.replace(
        port_cfg.featurizer, dither=0.0))
    variables = load_anchor(ANCHOR)
    tok = CharTokenizer(port_cfg.labels)
    rng = np.random.RandomState(0)
    texts = ["xin chào các bạn", "chào mừng"]
    tokens = np.zeros((2, 16), np.int32)
    for i, t in enumerate(texts):
        tokens[i, :len(t)] = tok.encode(t)
    batch_np = {"signal": (rng.randn(2, 16000) * 0.1).astype(np.float32),
                "signal_lens": np.array([16000, 12000], np.int32),
                "tokens": tokens,
                "token_lens": np.array([len(t) for t in texts], np.int32)}
    jax_opt = jax_make_optimizer("novograd", 0.01, weight_decay=0.001)
    _, jax_m = jax.jit(jax_make_train_step(
        jax_cfg, jax_opt, use_specaug=False, ctc_impl="pallas_interpret"))(
        JaxState.create(variables, jax_opt),
        {k: jnp.asarray(v) for k, v in batch_np.items()},
        jax.random.PRNGKey(0))
    state = train_state_from_jax(variables, optimizer=make_optimizer(
        "novograd", 0.01, weight_decay=0.001), device="cpu")
    state, m = make_train_step(port_cfg, use_specaug=False, device="cpu")(
        state, {k: torch.from_numpy(v) for k, v in batch_np.items()}, None)
    np.testing.assert_allclose(float(m["loss"]), float(jax_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jax_m["grad_norm"]), rtol=1e-4)
    assert int(state.skipped_steps) == 0


# ---------------------------------------------------------------------------
# Trainer, checkpoints, metrics, synthetic data


def test_trainer_fit_decreases_loss_and_evaluates(tmp_path):
    """30 steps on one fixed tone batch take the loss below 0.7x its first
    value (tests/test_train.py's check); eval, checkpointing and callbacks
    run."""
    _, cfg = _configs(dither=1e-5)
    gen = torch.Generator().manual_seed(0)
    variables = init_quartznet(gen, cfg.encoder, cfg.num_classes,
                               device="cpu")
    state = TrainState.create(variables, make_optimizer(
        "novograd", 0.01, weight_decay=0.001, grad_clip_norm=5.0))
    batch = SyntheticToneDataset(seed=0).batch(4)
    cm = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    tr = Trainer(cfg, use_specaug=False, log_every=1, device="cpu",
                 checkpoint_manager=cm, checkpoint_every=10,
                 monitor_progress=True)
    seen = []
    tr.callbacks.append(lambda trainer, m: seen.append(m["step"]))
    state = tr.fit(state, [batch] * 30)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses[::6]
    assert int(state.step) == 30 and int(state.skipped_steps) == 0
    assert seen == list(range(1, 31)) and "train_wer" in tr.history[-2]
    assert cm.list_steps() == [20, 30]
    result = tr.evaluate(state, [batch])
    assert result["num_utts"] == 4 and np.isfinite(result["eval_loss"])
    assert 0.0 <= result["cer"] <= 1.5


def test_trainer_same_seed_same_steps():
    """Dither and SpecAugment come from the Trainer's seeded generator: two
    fits from the same state give the same losses."""
    _, cfg = _configs(dither=1e-3)
    cfg = dataclasses.replace(cfg, spec_augment=SpecAugmentConfig(
        freq_masks=1, time_masks=1, freq_width=4, time_width=5))
    variables = init_quartznet(torch.Generator().manual_seed(1), cfg.encoder,
                               cfg.num_classes, device="cpu")
    batch = SyntheticToneDataset(seed=5).batch(2)
    runs = []
    for _ in range(2):
        state = TrainState.create(variables, make_optimizer("adam", 1e-3))
        tr = Trainer(cfg, log_every=1, seed=7, device="cpu",
                     prefetch_depth=0)
        tr.fit(state, [batch] * 3)
        runs.append([h["loss"] for h in tr.history if "loss" in h])
    assert runs[0] == runs[1] and len(runs[0]) == 3


def test_checkpoint_roundtrip_and_jax_checkpoint(tmp_path):
    """Port checkpoints: keep-K, restore of the newest into a state, the
    optimizer's moments and count included. A JAX state-STEP-N.msgpack
    restores its variables through the port's msgpack decoder."""
    jax_cfg, _ = _configs()
    variables = _jax_variables(jax_cfg, seed=6)
    factory = make_optimizer("novograd", 0.01)
    state = train_state_from_jax(variables, optimizer=factory, device="cpu")
    for p in state.param_list():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    cm = CheckpointManager(str(tmp_path / "port"), keep=2, device="cpu")
    for s in (1, 2, 3):
        state.step.fill_(s)
        cm.save(state)
    assert cm.list_steps() == [2, 3]
    fresh = train_state_from_jax(variables, optimizer=factory, device="cpu")
    assert cm.restore(fresh) is fresh and int(fresh.step) == 3
    for a, b in zip(fresh.param_list(), state.param_list()):
        assert torch.equal(a, b)
        assert torch.equal(fresh.optimizer.state[a]["exp_avg"],
                           state.optimizer.state[b]["exp_avg"])
    assert int(fresh.optimizer.param_groups[0]["step"]) == 1
    restored = cm.restore_variables(step=2)
    assert torch.equal(restored["params"]["decoder"]["b"],
                       state.params["decoder"]["b"])

    jax_opt = jax_make_optimizer("novograd", 0.01)
    jax_dir = str(tmp_path / "jax")
    JaxCheckpoints(jax_dir).save(JaxState.create(variables, jax_opt), 7)
    got = CheckpointManager(jax_dir, device="cpu").restore_variables()
    assert _max_diff(variables, got) == 0.0
    assert CheckpointManager(str(tmp_path / "empty"),
                             device="cpu").restore(fresh) is None


def test_metrics_tokenizer_and_synthetic_match_jax():
    from vietasr_tpu.audio.tokenizer import CharTokenizer as JaxTokenizer
    from vietasr_tpu.train import metrics as jax_metrics
    from vietasr_tpu.train.synthetic import \
        SyntheticToneDataset as JaxToneDataset
    from vietasr_tpu.train.synthetic import zeros_batch as jax_zeros_batch

    hyps, refs = ["xin chao cac ban", "a b"], ["xin chào các bạn", "a b c"]
    for use_cer in (False, True):
        assert word_error_rate(hyps, refs, use_cer) == \
            jax_metrics.word_error_rate(hyps, refs, use_cer)
    assert levenshtein("kitten", "sitting") == 3
    labels = load_config(CONFIG).labels
    for text in ("Xin chào các bạn", "giá xăng dầu", "ω"):
        assert CharTokenizer(labels).encode(text) == \
            JaxTokenizer(labels).encode(text)
    for got, want in ((SyntheticToneDataset(seed=2).batch(3),
                       JaxToneDataset(seed=2).batch(3)),
                      (zeros_batch(2), jax_zeros_batch(2))):
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_map_tree_keeps_structure():
    tree = {"a": [torch.ones(2), {"b": torch.zeros(1)}]}
    out = map_tree(lambda t: t + 1, tree)
    assert [t.tolist() for t in tree_leaves(out)] == [[2.0, 2.0], [1.0]]
