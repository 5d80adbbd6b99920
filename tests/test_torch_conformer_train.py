"""Conformer training in vietasr_tpu_torch (models/conformer.py's
training forward and remat, train/loop.py through the model_apply
dispatch) vs the JAX package's `conformer_apply(training=True)` and train
step, on the CPU, on JAX's own weights.

Tolerances, each with its reason:
- training forward (dropout 0, fp32): log-probs, the conv modules' new BN
  stats and the gradients of a seeded linear function of the log-probs
  within 1e-4 relative to each leaf's largest entry (fp32 sums in another
  order through 2 blocks of attention and convolutions).
- one train step (fp32, SGD lr 0.01): loss 1e-4 relative, parameters
  1e-5 absolute (the step moves each by lr times a gradient within 1e-4
  relative). SGD, not Novograd: the key bias's gradient is 0 up to
  rounding (softmax ignores a per-query constant), and Novograd's per-
  tensor normalisation would scale that noise up to a full step.
- remat: the same gradients as without it, to 1e-6 relative (the same
  ops recomputed; a reduction may split differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vietasr_tpu.models.conformer as J
from vietasr_tpu.config import ConformerConfig as JaxConformerConfig
from vietasr_tpu.config import DataConfig
from vietasr_tpu.config import EncoderConfig as JaxEncoderConfig
from vietasr_tpu.config import ModelConfig as JaxModelConfig
from vietasr_tpu.config import SpecAugmentConfig as JaxSpecAugmentConfig
from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeatCfg
from vietasr_tpu.models import model_init as jax_model_init
from vietasr_tpu.train import TrainState as JaxState
from vietasr_tpu.train import make_optimizer as jax_make_optimizer
from vietasr_tpu.train import make_train_step as jax_make_train_step
from vietasr_tpu_torch.config import (ConformerConfig, EncoderConfig,
                                      ModelConfig, SpecAugmentConfig)
from vietasr_tpu_torch.frontend.features import FeaturizerConfig
from vietasr_tpu_torch.models import conformer as P
from vietasr_tpu_torch.models.convert import (params_from_jax, to_numpy,
                                              train_state_from_jax)
from vietasr_tpu_torch.models.quartznet import map_tree, tree_leaves
from vietasr_tpu_torch.train import Trainer, make_optimizer, make_train_step
from vietasr_tpu_torch.train.loop import batch_to_tensors
from vietasr_tpu_torch.train.synthetic import SyntheticToneDataset

torch.set_num_threads(1)

LABELS = [" ", "a", "b", "c"]
MODES = {"conv2d": dict(), "stack_chunked": dict(subsampling_mode="stack",
                                                  chunk_size=4,
                                                  left_chunks=1)}


def make_cfgs(dropout=0.0, **over):
    kw = dict(num_blocks=2, d_model=32, num_heads=4, ff_expansion=2,
              conv_kernel=7, subsampling_channels=16, dropout=dropout)
    kw.update(over)
    fk = dict(features=16, dither=0.0, pad_to=8)
    jax_cfg = JaxModelConfig(
        name="tiny", labels=LABELS, featurizer=JaxFeatCfg(**fk),
        encoder=JaxEncoderConfig(blocks=(), feat_in=16),
        spec_augment=JaxSpecAugmentConfig(), data=DataConfig(),
        architecture="conformer", conformer=JaxConformerConfig(**kw))
    cfg = ModelConfig(
        name="tiny", labels=LABELS, featurizer=FeaturizerConfig(**fk),
        encoder=EncoderConfig(blocks=(), feat_in=16),
        spec_augment=SpecAugmentConfig(), architecture="conformer",
        conformer=ConformerConfig(**kw))
    return jax_cfg, cfg


def jax_variables(jax_cfg, seed=0):
    v = jax.tree_util.tree_map(np.asarray, jax_model_init(
        jax.random.PRNGKey(seed), jax_cfg))
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


def _feats(seed=1, bsz=3, t=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(bsz, t, 16).astype(np.float32),
            np.array([t, t - 9, t // 2 + 3][:bsz], np.int32))


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def _grads(variables, cfg, feats, lens, weight, **kw):
    """(log_probs, new_stats, {param path: grad}) of the port's training
    forward."""
    port = params_from_jax(variables, device="cpu")
    params = map_tree(lambda t: t.requires_grad_(True), port["params"])
    lp, _, stats = P.conformer_apply(
        {"params": params, "batch_stats": port["batch_stats"]},
        torch.from_numpy(feats), torch.from_numpy(lens), cfg=cfg.conformer,
        training=True, **kw)
    grads = torch.autograd.grad(torch.sum(lp * torch.from_numpy(weight)),
                                tree_leaves(params))
    it = iter(grads)
    return lp.detach(), stats, map_tree(lambda _: next(it), params)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_training_forward_matches_jax(mode):
    jax_cfg, cfg = make_cfgs(**MODES[mode])
    variables = jax_variables(jax_cfg, seed=2)
    feats, lens = _feats()
    want_lp0 = J.conformer_apply(variables, jnp.asarray(feats),
                                 jnp.asarray(lens), cfg=jax_cfg.conformer)[0]
    weight = np.random.RandomState(3).randn(*want_lp0.shape).astype(
        np.float32)

    def jax_loss(params):
        lp, _, st = J.conformer_apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), jnp.asarray(lens), cfg=jax_cfg.conformer,
            training=True)
        return jnp.sum(lp * weight), (lp, st)

    (_, (want_lp, want_stats)), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(variables["params"])
    got_lp, got_stats, got_grads = _grads(variables, cfg, feats, lens,
                                          weight)
    assert _rel(got_lp, want_lp) <= 1e-4
    stats_np = to_numpy(got_stats)
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, want_stats)):
        assert _rel(_at(stats_np, path), want) <= 1e-4, path
        n += 1
    assert n == 2 * cfg.conformer.num_blocks
    # training BN differs from the running stats it started from
    assert not np.allclose(stats_np["blocks"][0]["conv_bn"]["mean"],
                           variables["batch_stats"]["blocks"][0]["conv_bn"]
                           ["mean"])
    grads_np = to_numpy(got_grads)
    n = 0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, want_grads)):
        assert _rel(_at(grads_np, path), want) <= 1e-4, path
        n += 1
    assert n == len(tree_leaves(got_grads))


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_remat_gives_the_same_gradients(dropout):
    """remat=True recomputes each block in the backward pass; with dropout
    the recomputation draws the block's masks again from the same state,
    and the generator ends where it would without remat."""
    jax_cfg, cfg = make_cfgs(dropout=dropout)
    variables = jax_variables(jax_cfg, seed=4)
    feats, lens = _feats(seed=5)
    weight = np.random.RandomState(6).randn(3, 16, 5).astype(np.float32)
    runs = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(9)
        lp, _, grads = _grads(variables, cfg, feats, lens, weight,
                              remat=remat, generator=gen)
        runs.append((lp, tree_leaves(grads), torch.rand(3, generator=gen)))
    (lp0, g0, tail0), (lp1, g1, tail1) = runs
    assert torch.equal(lp0, lp1) and torch.equal(tail0, tail1)
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) \
            <= 1e-6 * max(1.0, float(a.abs().max()))
    if dropout:
        lp_eval = P.conformer_apply(
            params_from_jax(variables, device="cpu"),
            torch.from_numpy(feats), torch.from_numpy(lens),
            cfg=cfg.conformer)[0]
        assert not torch.allclose(lp0, lp_eval)


def test_dropout_draws_follow_the_generator():
    jax_cfg, cfg = make_cfgs(dropout=0.3)
    v = params_from_jax(jax_variables(jax_cfg), device="cpu")
    feats, lens = (torch.from_numpy(a) for a in _feats())
    outs = [P.conformer_apply(v, feats, lens, cfg=cfg.conformer,
                              training=True,
                              generator=torch.Generator().manual_seed(s))[0]
            for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_conformer_train_step_matches_jax():
    """One fp32 step through make_train_step (featurizer, Conformer in
    training mode, CTC through the kernel route's plain versions) vs JAX's
    step with its Pallas CTC pair in interpret mode."""
    jax_cfg, cfg = make_cfgs()
    variables = jax_variables(jax_cfg, seed=7)
    batch = SyntheticToneDataset(seed=8).batch(3)
    jax_opt = jax_make_optimizer("sgd", 1e-2, weight_decay=0.001)
    step = jax.jit(jax_make_train_step(jax_cfg, jax_opt, use_specaug=False,
                                       ctc_impl="pallas_interpret"))
    jax_state, jax_m = step(JaxState.create(variables, jax_opt), {
        k: jnp.asarray(getattr(batch, k))
        for k in ("signal", "signal_lens", "tokens", "token_lens")},
        jax.random.PRNGKey(0))
    state = train_state_from_jax(variables, optimizer=make_optimizer(
        "sgd", 1e-2, weight_decay=0.001), device="cpu")
    port_step = make_train_step(cfg, use_specaug=False, ctc_impl="kernel",
                                device="cpu")
    state, m = port_step(state, batch_to_tensors(batch, "cpu"), None)
    np.testing.assert_allclose(float(m["loss"]), float(jax_m["loss"]),
                               rtol=1e-4)
    # each leaf's update (new - initial) against JAX's, within 1e-4 of the
    # largest entry of JAX's update, plus the fp32 rounding of the new
    # parameter itself: the step is ~lr * (grad + wd * p), far below p
    params = to_numpy(state.params)
    before = jax.tree_util.tree_map(np.asarray, variables["params"])
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jax_state.params)):
        want_step = want - _at(before, path)
        scale = float(np.abs(want_step).max())
        assert scale > 0, path
        got_step = _at(params, path) - _at(before, path)
        assert (np.abs(got_step - want_step)
                <= 1e-4 * scale + np.spacing(np.abs(want))).all(), path
    stats = to_numpy(state.batch_stats)
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jax_state.batch_stats)):
        assert _rel(_at(stats, path), want) <= 1e-4, path


def test_trainer_on_a_conformer_with_remat():
    """The Trainer takes a Conformer config, with dropout and remat: finite
    losses, the step count, the BN stats moved."""
    jax_cfg, cfg = make_cfgs(dropout=0.1)
    state = train_state_from_jax(jax_variables(jax_cfg), optimizer=
                                 make_optimizer("lamb", 1e-3), device="cpu")
    before = state.batch_stats["blocks"][0]["conv_bn"]["mean"].clone()
    tr = Trainer(cfg, log_every=1, device="cpu", prefetch_depth=0,
                 remat=True)
    tr.fit(state, [SyntheticToneDataset(seed=1).batch(2)] * 2)
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert int(state.step) == 2 and int(state.skipped_steps) == 0
    assert not torch.equal(before,
                           state.batch_stats["blocks"][0]["conv_bn"]["mean"])
