"""The optimizers' list-wise step (train/optim.py) on the CPU: the guard
keeps every bit where a step is not finite, the train step's optimizer
span records as many ATen ops for 11 tensors as for 101, the counters of
engagement, and one all-reduce a norm vector under tensor parallelism.
The optimizers' agreement with optax is held in tests/test_torch_train.py
(test_optimizers_match_optax_on_a_mixed_tree)."""

import collections
import math

import pytest
import torch

from vietasr_tpu_torch.config import (BlockConfig, EncoderConfig, ModelConfig,
                                      SpecAugmentConfig)
from vietasr_tpu_torch.frontend.features import FeaturizerConfig
from vietasr_tpu_torch.models.quartznet import init_quartznet
from vietasr_tpu_torch.train import (TrainState, make_optimizer,
                                     make_schedule, make_train_step)
from vietasr_tpu_torch.train import optim
from vietasr_tpu_torch.train.freeze import unfreeze_schedule
from vietasr_tpu_torch.train.loop import batch_to_tensors
from vietasr_tpu_torch.train.synthetic import SyntheticToneDataset
from vietasr_tpu_torch.utils import tracing

SHAPES = [(11, 8), (8, 16), (16,), (1,), (5, 16), (16, 16), (3, 2, 2), (7,)]
# ATen ops that only make views (no kernel, no allocation of data)
VIEWS = {"aten::view", "aten::reshape", "aten::_reshape_alias",
         "aten::unflatten_dense_tensors", "aten::split",
         "aten::split_with_sizes", "aten::unbind", "aten::select",
         "aten::slice", "aten::narrow", "aten::as_strided", "aten::detach",
         "aten::alias", "aten::expand", "aten::view_as", "aten::squeeze",
         "aten::unsqueeze", "aten::t", "aten::transpose"}


def _params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).requires_grad_(True)
            for s in SHAPES]


def _set_grads(params, gen):
    for p in params:
        p.grad = 3 * torch.randn(p.shape, generator=gen)


def _snapshot(opt, params):
    return ([p.detach().clone() for p in params],
            [{k: v.clone() for k, v in opt.state[p].items()} for p in params],
            opt.param_groups[0]["step"].clone())


@pytest.mark.parametrize("name", ["novograd", "adam"])
def test_a_step_not_finite_keeps_every_bit(name):
    """Two finite steps, then one with NaN, inf and -inf in the gradients
    and `finite` False: parameters, both moments and the step counter are
    bit for bit as before it."""
    params = _params()
    opt = make_optimizer(name, make_schedule("CosineAnnealing", 0.05, 8,
                                             warmup_steps=2),
                         weight_decay=0.01, grad_clip_norm=5.0)(params)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        _set_grads(params, gen)
        opt.step(finite=torch.tensor(True))
    before = _snapshot(opt, params)
    _set_grads(params, gen)
    params[0].grad[2, 3] = float("nan")
    params[3].grad[0] = float("inf")
    params[5].grad[:] = -float("inf")
    opt.step(finite=torch.tensor(False))
    after = _snapshot(opt, params)
    assert set(after[1][0]) == {"exp_avg", "exp_avg_sq"}
    for p0, p1 in zip(before[0], after[0]):
        assert torch.equal(p0, p1)
    for s0, s1 in zip(before[1], after[1]):
        for key in s0:
            assert torch.equal(s0[key], s1[key]), key
    assert torch.equal(before[2], after[2]) and int(after[2]) == 2


def _dense_cfg(blocks: int) -> ModelConfig:
    """A QuartzNet of `blocks` dense 1x1 blocks: 3 blocks + 2 tensors."""
    block = BlockConfig(filters=16, kernel=1, stride=1, residual=False,
                        separable=False)
    return ModelConfig(name="dense", labels=[" ", "a", "b", "c"],
                       featurizer=FeaturizerConfig(features=16, dither=0.0,
                                                   pad_to=8),
                       encoder=EncoderConfig(blocks=(block,) * blocks,
                                             feat_in=16),
                       spec_augment=SpecAugmentConfig())


def _optimizer_span_ops(blocks: int):
    """(the top-level non-view ATen ops inside `vietasr.train.optimizer`
    in a train step, by name; the number of parameter tensors; the
    tracing summary), measured on the second step (the first builds the
    optimizer's state)."""
    cfg = _dense_cfg(blocks)
    variables = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                               cfg.num_classes)
    state = TrainState.create(variables, make_optimizer(
        "novograd", make_schedule("CosineAnnealing", 0.05, 8, warmup_steps=2),
        weight_decay=0.001, grad_clip_norm=5.0))
    step = make_train_step(cfg, use_specaug=False, ctc_impl="kernel",
                           device="cpu")
    batch = batch_to_tensors(SyntheticToneDataset(seed=0).batch(2), "cpu")
    step(state, batch, None)
    with torch.profiler.profile() as prof:
        step(state, batch, None)
        summary = tracing.summary()
    root = next(e for e in prof.events()
                if e.name == tracing.PREFIX + "train.optimizer")
    ops = []

    def walk(event):
        for child in event.cpu_children:
            if child.name.startswith("aten::"):
                ops.append(child.name)
            else:                    # a record_function range: look inside
                walk(child)

    walk(root)
    return (collections.Counter(o for o in ops if o not in VIEWS),
            len(state.param_list()), summary)


def test_optimizer_span_ops_do_not_grow_with_the_tensors():
    """The norm, the guard, Novograd's clipped step and the BN statistics
    take the same 76 ATen ops at 11 and at 101 tensors (a loop over the
    tensors took 657 and 5,907)."""
    few, n_few, s_few = _optimizer_span_ops(3)
    many, n_many, s_many = _optimizer_span_ops(33)
    assert (n_few, n_many) == (11, 101)
    assert few == many
    assert sum(many.values()) < 150
    assert s_few["optim.multi_tensor"] == n_few
    assert s_many["optim.multi_tensor"] == n_many


def test_counters_of_the_list_path():
    """With tracing on, a step counts each tensor it updates once under
    `optim.multi_tensor`; a group under an unfreeze schedule too (its gates
    are list-wise), so `optim.per_tensor` counts none. Off, nothing is
    counted."""
    params = _params()
    paths = [f"encoder/{i}/w" if i % 2 else f"decoder/{i}"
             for i in range(len(params))]
    plain = make_optimizer("adam", 0.01)([{"params": params[:3]}])
    gated = unfreeze_schedule(make_optimizer("adam", 0.01),
                              {"encoder": 3})(
        [{"params": params[3:], "paths": paths[3:]}])
    gen = torch.Generator().manual_seed(2)
    _set_grads(params, gen)
    plain.step()
    with torch.profiler.profile():
        plain.step()
        gated.step()
        gated.step()
        counts = tracing.summary()
    assert counts["optim.multi_tensor"] == 3 + 2 * (len(params) - 3)
    assert counts.get("optim.per_tensor", 0) == 0
    before = tracing.summary()
    plain.step()
    assert tracing.summary() == before


def test_tensor_parallel_norms_take_one_all_reduce(monkeypatch):
    """Under tensor parallelism the sharded tensors' sums of squares are
    all-reduced once a norm vector, whatever the number of tensors: one
    call a step, the clip's, whose sums Novograd's second moment reuses.
    The stand-in all-reduce sums two equal ranks (doubles)."""
    calls = []

    def all_reduce(t, group=None):
        calls.append(t.shape)
        t.mul_(2)

    monkeypatch.setattr(optim.dist, "all_reduce", all_reduce)
    params = _params()
    sharded = [i % 3 == 0 for i in range(len(params))]
    whole = sum(float(p.detach().square().sum()) * (2 if s else 1)
                for p, s in zip(params, sharded))
    got = optim.global_norm([p.detach() for p in params], sharded,
                            group=object())
    assert calls == [(len(params),)]
    assert math.isclose(float(got), math.sqrt(whole), rel_tol=1e-6)
    calls.clear()
    opt = make_optimizer("novograd", 0.01, grad_clip_norm=5.0)(params)
    opt.tensor_parallel([p for p, s in zip(params, sharded) if s], object())
    _set_grads(params, torch.Generator().manual_seed(3))
    opt.step()
    assert calls == [(len(params),)]
    # the first second moment is the clipped gradient's sum of squares,
    # of the whole tensor (both ranks') where it is sharded
    sq = [float(p.grad.square().sum()) * (2 if s else 1)
          for p, s in zip(params, sharded)]
    scale = min(1.0, 5.0 / math.sqrt(sum(sq))) ** 2
    for p, want in zip(params, sq):
        assert math.isclose(float(opt.state[p]["exp_avg_sq"]), want * scale,
                            rel_tol=1e-5)
