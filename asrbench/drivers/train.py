"""Training from bucketed batches: the port's `Trainer.fit` drives the
step of `make_train_step` (bf16 compute, the CTC kernels, Novograd) over
the port's `BucketBatcher`, which reads an in-memory dataset of the mix's
clips and transcripts made in set-up. The weights start from the seed.

Set-up builds one TrainState, takes it through its first steps through
the same `fit` and the same feed as the window (the output check's three
steps, then one step of every bucket shape), and hands that state to the
window. The window's metric is the audio seconds of the steps it
completed over its wall seconds.

The output check: the reference follows the first three steps from the
same weights, batches and dither draws; it compares each step's loss,
each tensor's first gradient norm as Novograd's second moment holds it
after step 1, and each tensor's change over the three steps.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from asrbench import synth
from asrbench.drivers import common
from asrbench.trace import Stretch, span

STEPS_JUDGED = 3
GRAD_FLOOR = 1e-3      # leaves whose step-1 reference gradient lies under
#                        this share of the median leaf's are left out of
#                        the change (round-off alone moves them)


def imports():
    from asrbench.reference import precision, train  # noqa: F401
    from vietasr_tpu_torch.audio import dataset, manifest  # noqa: F401
    from vietasr_tpu_torch.audio import tokenizer  # noqa: F401
    from vietasr_tpu_torch import config  # noqa: F401
    from vietasr_tpu_torch.train import Trainer  # noqa: F401


class MemoryDataset:
    """Clips and transcripts in memory, with the fields BucketBatcher
    reads: entries with durations, the sample rate, items, the longest
    transcript."""

    def __init__(self, sigs, texts, tokenizer, max_tokens):
        from vietasr_tpu_torch.audio.manifest import ManifestEntry

        self.sigs = sigs
        self.ids = [tokenizer.encode(t) for t in texts]
        if any(i is None or not 0 < len(i) <= max_tokens for i in self.ids):
            raise ValueError("train mix: a transcript outside 1.."
                             f"{max_tokens} labels")
        self.sample_rate = synth.SR
        self.entries = [ManifestEntry("memory://", len(s) / synth.SR, t)
                        for s, t in zip(sigs, texts)]
        self.num_dropped = 0
        self.max_tokens = max_tokens

    def __len__(self):
        return len(self.sigs)

    def max_token_len(self):
        return self.max_tokens

    def __getitem__(self, i):
        return self.sigs[i], self.ids[i]


def _endless(batcher):
    while True:
        yield from batcher


def run(ctx):
    import torch
    from vietasr_tpu_torch.audio.dataset import BucketBatcher
    from vietasr_tpu_torch.audio.tokenizer import CharTokenizer
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.train import (TrainState, Trainer,
                                         make_optimizer)

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    mark = common.Marks(ctx.t_start)
    mark("start")
    mcfg = load_config(common.write_yaml(cfg, ctx.tmpdir))
    variables = common.variables(cfg, ctx.seed, dev)
    common.sync(dev)
    mark("weights")
    sigs, texts = synth.utterances(ctx.seed, mix["clips"], mix["min_s"],
                                   mix["max_s"], cfg["labels"])
    mark("traffic")
    ds = MemoryDataset(sigs, texts, CharTokenizer(cfg["labels"]),
                       mix["max_tokens"])
    buckets = [int(s * synth.SR) for s in mix["buckets_s"]]
    batcher = BucketBatcher(ds, mix["batch"], buckets=buckets,
                            seed=ctx.seed % 2 ** 31)
    mark("batcher")
    opt = mix["optimizer"]
    state = TrainState.create(variables, make_optimizer(
        "novograd", opt["lr"], betas=tuple(opt["betas"]),
        weight_decay=opt["weight_decay"],
        grad_clip_norm=opt["grad_clip_norm"]))
    mark("train_state")
    gen_seed = ctx.seed % 2 ** 63
    trainer = Trainer(mcfg, compute_dtype=cfg["compute_dtype"], log_every=1,
                      seed=gen_seed, device=dev, ctc_impl="auto",
                      prefetch_depth=mix["prefetch_depth"])
    mark("trainer")
    step_fn = trainer._train_step

    def traced_step(*a):
        with span("train_step"):
            return step_fn(*a)

    trainer._train_step = traced_step
    feed = _endless(batcher)
    shapes = None               # the traced stretch's batches

    def fetch(go=None, acc=None):
        while go is None or go():
            with span("fetch"):
                b = next(feed)
            if shapes is not None:
                shapes.append(b)
            if acc is not None:
                acc["audio"] += float(b.signal_lens.sum()) / synth.SR
            yield b

    # the judged steps, through the window's own call and feed
    first = {}
    params = state.params
    start = {k: v.detach().clone() for k, v in _leaves(params).items()}

    def on_step(tr, m):
        if not first:
            for k, p in _leaves(params).items():
                first[k] = float(torch.sqrt(
                    state.optimizer.state[p]["exp_avg_sq"]))

    trainer.callbacks.append(on_step)
    taken = list(itertools.islice(fetch(), STEPS_JUDGED))
    judged = [_batch_dict(b) for b in taken]
    mark("first_batches")
    if ctx.control:
        return control(ctx, variables, judged)
    state = trainer.fit(state, iter(taken))
    mark("judged_steps")
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    change = {k: float(torch.linalg.norm(v.detach() - start[k]))
              for k, v in _leaves(params).items()}
    trainer.callbacks.clear()
    trainer.log_every = 0
    # one step of every bucket shape the window will see
    needed = {next(b for b in buckets if len(x) <= b) for x in sigs}
    warm, seen = [], set()
    while seen != needed:
        b = next(feed)
        warm.append(b)
        seen.add(b.signal.shape[1])
    state = trainer.fit(state, iter(warm))
    common.sync(dev)
    mark("warm_steps")
    setup_s = time.perf_counter() - ctx.t_start

    acc = {"audio": 0.0}
    stretch, traced = (Stretch() if ctx.trace else None), None
    step0 = int(state.step)
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds
    until = lambda t: lambda: time.perf_counter() < t  # noqa: E731
    if stretch is None:
        state = trainer.fit(state, fetch(until(t_end), acc))
    else:
        # untraced, traced stretch, untraced: three fits on one feed
        state = trainer.fit(state, fetch(until(t0 + ctx.trace_start_s), acc))
        shapes = []
        stretch.start()
        launches0 = common.launches()
        state = trainer.fit(state, fetch(
            until(time.perf_counter() + ctx.trace_seconds), acc))
        traced = stretch.stop()
        traced.update(launches=common.launches_since(launches0),
                      batches=[(b.signal.shape, b.signal_lens.copy(),
                                b.token_lens.copy(), b.tokens.shape[1])
                               for b in shapes],
                      audio_s=sum(float(b.signal_lens.sum()) for b in shapes)
                      / synth.SR)
        shapes = None
        state = trainer.fit(state, fetch(until(t_end), acc))
    common.sync(dev)
    wall = time.perf_counter() - t0
    steps = int(state.step) - step0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del trainer, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(ctx, variables, judged, (losses, first, change))
    return {"metrics": {"train_audio_s_per_s": acc["audio"] / wall,
                        "setup_s": setup_s},
            "checks": checks, "attempted": steps,
            "failed": sum(v > lim for v, lim in checks.values()),
            "memory_peak_bytes": peak, "trace": traced,
            "info": {"steps": steps, "wall_s": wall, "losses": losses,
                     "setup_split": mark.split}}


def _leaves(tree):
    from asrbench.reference.train import flat_leaves
    return flat_leaves(tree)


def _batch_dict(b) -> dict:
    return {"signal": b.signal.copy(), "signal_lens": b.signal_lens.copy(),
            "tokens": b.tokens.copy(), "token_lens": b.token_lens.copy()}


def _noises(ctx, judged):
    """The dither's standard normals of the judged steps, drawn as the
    trainer draws them: one generator on the device seeded as the
    trainer's, one (B, S) draw a step."""
    import torch

    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed % 2 ** 63)
    return [torch.randn(b["signal"].shape, generator=gen, device=ctx.device)
            for b in judged]


def _model(cfg):
    return {"featurizer": cfg["featurizer"], "blocks": cfg["blocks"],
            "labels": cfg["labels"]}


def reference_steps(ctx, variables, judged, quant=None, rows=None):
    """The reference's (losses, first gradient norms, changes, raw step-1
    gradient norms) over the judged steps; `rows` keeps only the first
    rows of each batch (the half-batch fault)."""
    from asrbench.reference import train as rtrain

    noises = _noises(ctx, judged)
    if rows is not None:
        judged = [{k: v[:rows] for k, v in b.items()} for b in judged]
        noises = [n[:rows] for n in noises]
    with common.strict_fp32():
        return rtrain.run_steps(variables, judged, noises,
                                _model(ctx.config),
                                ctx.traffic["optimizer"], quant=quant)


def judge(ctx, variables, judged, prog):
    """The program's (losses, first gradient norms, changes) against the
    reference's: the loss by its relative gap at the worst step; the norms
    by the worst tensor, each gap over the larger of that tensor's
    reference norm and the median tensor's."""
    losses, first, change = prog
    r_loss, r_first, r_change, raw = reference_steps(ctx, variables, judged)
    lim = ctx.limits
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_loss))
    med = float(np.median(list(r_first.values())))
    grad_gap = max(abs(first[k] - r_first[k]) / max(r_first[k], med)
                   for k in r_first)
    raw_med = float(np.median(list(raw.values())))
    moved = [k for k in r_change if raw[k] >= GRAD_FLOOR * raw_med]
    c_med = float(np.median([r_change[k] for k in moved]))
    change_gap = max(abs(change[k] - r_change[k]) / max(r_change[k], c_med)
                     for k in moved)
    return {"loss_rel_gap": [loss_gap, lim["loss_rel_gap"]],
            "grad_norm_gap": [grad_gap, lim["grad_norm_gap"]],
            "change_gap": [change_gap, lim["change_gap"]],
            "steps_judged": [STEPS_JUDGED - len(losses), 0]}


def control(ctx, variables, judged):
    """Readings of a control or a fault, in the program's place, on the
    judged steps: "fp8" the reference with every convolution's operands in
    float8 e4m3, "half_batch" the reference on the first half of each
    batch's rows (the mean over the rest)."""
    from asrbench.reference import precision

    b = len(judged[0]["signal"])
    if ctx.control == "fp8":
        out = reference_steps(ctx, variables, judged, quant=precision.fp8)
    elif ctx.control == "half_batch":
        out = reference_steps(ctx, variables, judged, rows=b // 2)
    else:
        raise SystemExit(f"train: no control {ctx.control!r}")
    checks = judge(ctx, variables, judged, out[:3])
    return {"metrics": {}, "checks": checks, "attempted": 0,
            "failed": sum(v > lim for v, lim in checks.values()),
            "memory_peak_bytes": 0, "trace": None, "info": {}}
