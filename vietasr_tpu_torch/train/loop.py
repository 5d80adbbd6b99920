"""Train/eval steps and the Trainer loop (counterpart of
vietasr_tpu/train/loop.py).

- forward = featurize (dither) -> SpecAugment -> the encoder in training
  mode through the `model_apply` dispatch (QuartzNet/Jasper or the
  Conformer; batch-stat BN, dropout) -> CTC loss; autograd takes the
  gradient.
- value schedules ({name: fn(step)}, train/freeze.py): evaluated on the
  step count each step; `specaug_freq_masks` / `specaug_time_masks` set
  the live SpecAugment band counts, and every value is reported in the
  metrics.
- gradient accumulation over microbatches, the BN running stats carried
  from one microbatch to the next.
- NaN/inf guard: a non-finite loss or global grad norm skips the update
  of params, BN stats and optimizer state and counts the skip, all on the
  device (no host round trip inside the step).

Routes on the GPU: the featurizer is the log-mel CUDA kernel
(frontend/cuda_frontend.py; features carry no gradient, and the dither is
added to the waveform before it), the CTC loss the alpha/beta CUDA kernel
pair (`ctc_impl="auto"`). On CPU tensors both take their plain versions,
the featurizer the plain log-mel chain as JAX computes it.

The Trainer can record a `torch.profiler` trace of steps [profile_start,
profile_stop) into `profile_dir`. While a profiler records, the loop's
spans (utils/tracing.py) mark each step (`vietasr.train.step`) and its
parts: the batch wait, the upload, each microbatch's forward and
backward, the optimizer, the log read-back.

The JAX train step returns a new state; here the step updates `state` in
place and returns it. Random numbers (dither, SpecAugment masks, dropout)
come from one torch.Generator, drawn in that order; the JAX package splits
a key, so the draws differ and their distributions do not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from vietasr_tpu_torch.config import ModelConfig
from vietasr_tpu_torch.frontend.cuda_frontend import (fused_supported,
                                                      make_fused_featurizer)
from vietasr_tpu_torch.frontend.features import make_featurizer
from vietasr_tpu_torch.models import model_apply
from vietasr_tpu_torch.models.quartznet import assign_tree, tree_paths
from vietasr_tpu_torch.ops.ctc_loss import CTC_IMPLS, ctc_loss
from vietasr_tpu_torch.ops.greedy import (collapse_batch, greedy_decode,
                                          ids_to_text)
from vietasr_tpu_torch.ops.specaug import apply_spec_augment
from vietasr_tpu_torch.parallel.distributed import (gather_eval_results,
                                                    is_main_process)
from vietasr_tpu_torch.parallel.tp import conformer_tp_spec
from vietasr_tpu_torch.train.metrics import levenshtein, word_error_rate
from vietasr_tpu_torch.train.optim import global_norm
from vietasr_tpu_torch.train.state import TrainState
from vietasr_tpu_torch.utils import tracing
from vietasr_tpu_torch.utils.device import resolve_device
from vietasr_tpu_torch.utils.typing import assert_audio_batch, assert_labels

_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
BATCH_KEYS = ("signal", "signal_lens", "tokens", "token_lens")


def batch_to_tensors(batch, device) -> Dict[str, torch.Tensor]:
    """A Batch of numpy arrays -> {signal, signal_lens, tokens,
    token_lens} tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(batch, k)))
            .to(device) for k in BATCH_KEYS}


def make_train_featurizer(cfg: ModelConfig, device: torch.device):
    """featurize(signal, lengths, *, generator, training): the log-mel
    kernel on the GPU where fused_supported, else the plain chain."""
    fused = device.type == "cuda" and fused_supported(cfg.featurizer)
    return (make_fused_featurizer if fused else make_featurizer)(
        cfg.featurizer, device=device)


def make_loss_fn(cfg: ModelConfig, *, use_specaug: bool = True,
                 compute_dtype: Optional[torch.dtype] = None,
                 ctc_impl: str = "auto", device=None, remat: bool = False,
                 group=None, tp_group=None):
    """loss_fn(params, batch_stats, batch, generator, training, sched=None)
    -> (loss, (new_stats, log_probs, enc_lens)).

    compute_dtype=torch.bfloat16 runs the encoder's convolutions and
    products in bf16 with fp32 params and accumulation. `sched` (the value
    schedules' values) may set the live SpecAugment band counts. Padded
    rows (signal_lens == 0) and CTC-infeasible rows (the ~1e30 sentinel)
    are masked per sample, torch CTCLoss(zero_infinity=True) semantics, and
    the loss is the mean over the remaining rows. `remat` recomputes each
    Conformer block in the backward pass (a QuartzNet refuses it).

    With a data-parallel process `group` the batch is this rank's rows of
    a global batch: the training-mode BN statistics are the global batch's
    and the loss is this rank's share of the global mean, the sum of its
    valid rows over the all-reduced count of valid rows (the shares sum
    to the one-process loss on the global batch, whichever rank holds
    the padding rows). `tp_group` runs a Conformer tensor-parallel over
    its ranks (parallel/tp.py); `params` is then this rank's shard."""
    if ctc_impl not in CTC_IMPLS:
        raise ValueError(f"ctc_impl must be one of {CTC_IMPLS}, "
                         f"got {ctc_impl!r}")
    if remat and cfg.architecture != "conformer":
        raise ValueError("remat applies to the Conformer only")
    if tp_group is not None and cfg.architecture != "conformer":
        raise ValueError("tensor parallelism applies to the Conformer only")
    featurize = make_train_featurizer(cfg, resolve_device(device))
    blank = cfg.num_classes
    extra = {"remat": True} if remat else {}
    if tp_group is not None:
        extra["tp_group"] = tp_group

    def loss_fn(params, batch_stats, batch, generator, training: bool,
                sched=None):
        assert_audio_batch(batch["signal"], batch["signal_lens"])
        assert_labels(batch["tokens"], batch["token_lens"])
        feats, flens = featurize(batch["signal"], batch["signal_lens"],
                                 generator=generator, training=training)
        if training and use_specaug:
            sched = sched or {}
            feats = apply_spec_augment(
                feats, cfg.spec_augment, generator=generator,
                active_freq=sched.get("specaug_freq_masks"),
                active_time=sched.get("specaug_time_masks"))
        variables = {"params": params, "batch_stats": batch_stats}
        groups = {"bn_group": group} if training and group is not None \
            else {}
        out = model_apply(variables, feats, flens, cfg=cfg,
                          compute_dtype=compute_dtype, training=training,
                          generator=generator, **groups, **extra)
        log_probs, enc_lens = out[:2]
        new_stats = out[2] if training else batch_stats
        per_sample = ctc_loss(log_probs, batch["tokens"], enc_lens,
                              batch["token_lens"], blank=blank,
                              reduction="none", impl=ctc_impl)
        valid = (batch["signal_lens"] > 0) & torch.isfinite(per_sample) \
            & (per_sample < 1e25)
        per_sample = torch.where(valid, per_sample,
                                 torch.zeros_like(per_sample))
        if group is None:
            count = valid.sum()
        else:
            count = valid.sum().to(per_sample.dtype)
            dist.all_reduce(count, group=group)
        loss = per_sample.sum() / torch.clamp_min(count, 1)
        return loss, (new_stats, log_probs, enc_lens)

    return loss_fn


def make_train_step(cfg: ModelConfig, *, grad_accum: int = 1,
                    use_specaug: bool = True,
                    lr_schedule: Optional[Callable] = None,
                    compute_dtype: Optional[torch.dtype] = None,
                    ctc_impl: str = "auto", device=None,
                    value_schedules: Optional[dict] = None,
                    remat: bool = False, group=None, tp_group=None):
    """train_step(state, batch, generator) -> (state, metrics): one update
    of `state` (in place) from a batch of tensors; metrics are device
    tensors (loss, grad_norm, lr with a schedule, and each value
    schedule's value at the step count before the update).

    Data parallelism: with a process `group` the batch is this rank's rows
    and the step equals the one-process step on the global batch (the
    union of the ranks' rows; with grad_accum > 1, microbatch k of the
    global batch is the union of the ranks' microbatches k). The loss
    (make_loss_fn) and the BN statistics are global, and after
    accumulation the gradients and the loss are sum-all-reduced once, in
    one flat fp32 bucket, so the NaN/inf guard sees the same loss and
    gradient norm on every rank and every rank skips the same steps.
    `tp_group` runs a Conformer tensor-parallel (parallel/tp.py): the
    state holds this rank's shard, and the guard's norm and every
    per-tensor norm of the optimizer are taken over the whole tensors."""
    loss_fn = make_loss_fn(cfg, use_specaug=use_specaug,
                           compute_dtype=compute_dtype, ctc_impl=ctc_impl,
                           device=device, remat=remat, group=group,
                           tp_group=tp_group)

    def grads_of(state: TrainState, stats, batch, generator, sched):
        with tracing.span("train.forward_backward"):
            loss, (new_stats, _, _) = loss_fn(state.params, stats, batch,
                                              generator, True, sched)
            grads = torch.autograd.grad(loss, state.param_list())
        return loss.detach(), new_stats, grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]):
        sched = {k: fn(state.step)
                 for k, fn in (value_schedules or {}).items()}
        if grad_accum > 1:
            bsz = batch["signal"].shape[0]
            if bsz % grad_accum:
                raise ValueError(f"batch {bsz} does not split into "
                                 f"{grad_accum} microbatches")
            m = bsz // grad_accum
            new_stats, grads, loss = state.batch_stats, None, 0.0
            for k in range(grad_accum):
                micro = {key: v[k * m:(k + 1) * m] for key, v in batch.items()}
                loss_k, new_stats, grads_k = grads_of(state, new_stats, micro,
                                                      generator, sched)
                grads = grads_k if grads is None \
                    else [a + b for a, b in zip(grads, grads_k)]
                loss = loss + loss_k
            grads = [g / grad_accum for g in grads]
            loss = loss / grad_accum
        else:
            loss, new_stats, grads = grads_of(state, state.batch_stats, batch,
                                              generator, sched)

        with tracing.span("train.optimizer"):
            if group is not None:
                flat = torch.cat([g.reshape(-1) for g in grads]
                                 + [loss.reshape(1).to(torch.float32)])
                dist.all_reduce(flat, group=group)
                loss = flat[-1]
                grads = [a.view_as(g) for a, g in zip(
                    flat[:-1].split([g.numel() for g in grads]), grads)]
            params = state.param_list()
            # a masked NaN row can leave the loss finite while the gradients
            # are NaN (it still reaches the BN batch stats), so guard both
            if tp_group is not None:
                sharded = [conformer_tp_spec(p) is not None
                           for p in tree_paths(state.params)]
                state.optimizer.tensor_parallel(
                    [p for p, s in zip(params, sharded) if s], tp_group)
                grad_norm = global_norm(grads, sharded, tp_group)
            else:
                grad_norm = global_norm(grads)
            finite = torch.isfinite(loss) & (loss < 1e25) \
                & torch.isfinite(grad_norm)
            for p, g in zip(params, grads):
                p.grad = torch.where(finite, g, torch.zeros_like(g))
            state.optimizer.step(finite=finite)
            for p in params:     # frozen parameters are not the optimizer's
                p.grad = None
            with torch.no_grad():
                assign_tree(state.batch_stats, new_stats, finite)
                state.step += 1
                state.skipped_steps += (~finite).to(torch.int32)
        metrics = {"loss": loss,
                   "grad_norm": torch.where(finite, grad_norm,
                                            torch.full_like(grad_norm,
                                                            float("inf")))}
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(state.step)
        metrics.update(sched)
        return state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, ctc_impl: str = "auto", device=None):
    """eval_step(params, batch_stats, batch) -> {loss, preds, keep,
    enc_lens}: the fp32 eval forward (running-stat BN), no gradient."""
    loss_fn = make_loss_fn(cfg, use_specaug=False, ctc_impl=ctc_impl,
                           device=device)
    blank = cfg.num_classes

    @torch.no_grad()
    def eval_step(params, batch_stats, batch):
        loss, (_, log_probs, enc_lens) = loss_fn(params, batch_stats, batch,
                                                 None, False)
        preds, keep = greedy_decode(log_probs, enc_lens, blank=blank)
        return {"loss": loss, "preds": preds, "keep": keep,
                "enc_lens": enc_lens}

    return eval_step


def _prefetch(iterable, depth: int = 2):
    """Background-thread batch prefetch: host-side batch preparation runs
    while the device executes the previous step. Worker exceptions
    re-raise at the consumer; a consumer that stops early releases the
    worker."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
            _put(done)
        except BaseException as e:        # forwarded, not swallowed
            _put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


@dataclasses.dataclass
class Trainer:
    """Epoch/step loop with callbacks, eval and checkpointing (the JAX
    Trainer's fields, less `optimizer`, which the TrainState holds here;
    plus `remat` for the Conformer). Callbacks are plain callables
    fn(trainer, metrics_dict) invoked every `log_every` steps.
    `device=None` means CUDA, and raises without a GPU.

    `process_group` trains data-parallel over its ranks (make_train_step):
    each rank's batcher yields its rows of the same global batches, so
    every rank takes the same steps; SpecAugment, dither and dropout draw
    from a generator seeded with seed + 1000 x rank; only rank 0 writes
    checkpoints; `evaluate` sums every rank's counts over its own shard
    of the eval set."""

    cfg: ModelConfig
    grad_accum: int = 1
    use_specaug: bool = True
    lr_schedule: Optional[Callable] = None
    compute_dtype: Optional[str] = None      # e.g. "bfloat16"
    log_every: int = 10
    eval_every: int = 0
    checkpoint_manager: Optional[object] = None
    checkpoint_every: int = 0
    seed: int = 0
    # torch.profiler trace of steps [profile_start, profile_stop) written
    # here as trace_steps_<start>_<stop>.json
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_stop: int = 13
    # log a sample hyp/ref + batch WER every log_every steps
    monitor_progress: bool = False
    # "auto": the CUDA kernel pair on the GPU, the plain recursion on CPU
    ctc_impl: str = "auto"
    # background-thread batch prefetch depth (0 disables)
    prefetch_depth: int = 2
    # {name: fn(step) -> scalar} annealed knobs (train/freeze.py
    # make_value_schedule)
    value_schedules: Optional[dict] = None
    # recompute each Conformer block in the backward pass
    remat: bool = False
    device: Optional[object] = None
    process_group: Optional[object] = None

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        self.device = resolve_device(self.device)
        self._train_step = make_train_step(
            self.cfg, grad_accum=self.grad_accum,
            use_specaug=self.use_specaug, lr_schedule=self.lr_schedule,
            compute_dtype=_DTYPES[self.compute_dtype],
            ctc_impl=self.ctc_impl, device=self.device,
            value_schedules=self.value_schedules, remat=self.remat,
            group=self.process_group)
        self._profiler = None
        self._eval_step = make_eval_step(self.cfg, ctc_impl=self.ctc_impl,
                                         device=self.device)
        self.callbacks = []
        self.history = []

    def fit(self, state: TrainState, batcher: Iterable, *,
            num_epochs: int = 1, eval_batcher: Optional[Iterable] = None
            ) -> TrainState:
        generator = torch.Generator(device=self.device)
        rank = 0 if self.process_group is None \
            else dist.get_rank(self.process_group)
        generator.manual_seed(self.seed + 1000 * rank)
        step = int(state.step)
        try:
            for epoch in range(num_epochs):
                t_epoch = time.time()
                it = iter(_prefetch(iter(batcher), depth=self.prefetch_depth)
                          if self.prefetch_depth > 0 else batcher)
                while True:
                    with tracing.span("train.batch_wait"):
                        batch = next(it, None)
                    if batch is None:
                        break
                    t0 = time.time()
                    self._profile_enter(step)
                    log = self.log_every and (step + 1) % self.log_every == 0
                    with tracing.span("train.step"):
                        self._count_batch(batch)
                        with tracing.span("train.upload"):
                            tensors = batch_to_tensors(batch, self.device)
                        state, metrics = self._train_step(state, tensors,
                                                          generator)
                        if log:
                            with tracing.span("train.log_read"):
                                m = {k: float(v) for k, v in metrics.items()}
                    step += 1
                    self._profile_exit(step)
                    if log:
                        m.update(step=step, epoch=epoch,
                                 step_time=time.time() - t0)
                        if self.monitor_progress:
                            m.update(self._progress_sample(state, batch))
                        self.history.append(m)
                        for cb in self.callbacks:
                            cb(self, m)
                    if (self.eval_every and eval_batcher is not None
                            and step % self.eval_every == 0):
                        self.evaluate(state, eval_batcher)
                    if (self.checkpoint_manager is not None
                            and is_main_process()
                            and self.checkpoint_every
                            and step % self.checkpoint_every == 0):
                        self.checkpoint_manager.save(state, step)
                self.history.append({"epoch": epoch,
                                     "epoch_time": time.time() - t_epoch})
        except BaseException:
            self._profile_abort()
            raise
        # a window still open when fit ends (fewer steps than profile_stop)
        # is stopped and written, so no profiler, and no span, outlives fit
        self._profile_exit(step, end=True)
        return state

    @staticmethod
    def _count_batch(batch) -> None:
        if tracing.enabled():
            signal_samples = int(batch.signal_lens.sum())
            tracing.count("train.steps")
            tracing.count("train.rows", batch.signal.shape[0])
            tracing.count("train.signal_samples", signal_samples)
            tracing.count("train.padded_samples",
                          batch.signal.size - signal_samples)

    def _profile_enter(self, step: int) -> None:
        if self.profile_dir is None or self._profiler is not None \
                or step != self.profile_start:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def _profile_exit(self, step: int, *, end: bool = False) -> None:
        """Stop and write the window at profile_stop, or at the end of fit
        (`end`) if it is still open: trace_steps_<start>_<step>.json holds
        steps [start, step)."""
        if self._profiler is None or (step != self.profile_stop
                                      and not end):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(
            self.profile_dir,
            f"trace_steps_{self.profile_start}_{step}.json"))
        self._profiler = None

    def _profile_abort(self) -> None:
        """Stop a window still open when fit raises, writing nothing: a
        failed device would raise again in a synchronize or the export,
        over the error that ended fit."""
        prof, self._profiler = self._profiler, None
        if prof is not None:
            with contextlib.suppress(Exception):
                prof.stop()

    def _decode(self, state: TrainState, batch):
        """(hyps, refs, loss) of one batch, padded rows skipped."""
        labels = self.cfg.labels
        out = self._eval_step(state.params, state.batch_stats,
                              batch_to_tensors(batch, self.device))
        seqs = collapse_batch(out["preds"].cpu(), out["keep"].cpu())
        hyps, refs = [], []
        for i, ids in enumerate(seqs):
            if batch.signal_lens[i] == 0:
                continue
            hyps.append(ids_to_text(ids, labels))
            refs.append("".join(
                labels[t] for t in batch.tokens[i, : batch.token_lens[i]]))
        return hyps, refs, float(out["loss"])

    def _progress_sample(self, state: TrainState, batch) -> dict:
        """One hyp/ref pair and the batch WER of the current batch."""
        hyps, refs, _ = self._decode(state, batch)
        if not hyps:
            return {}
        return {"train_wer": word_error_rate(hyps, refs),
                "sample_hyp": hyps[0], "sample_ref": refs[0]}

    def evaluate(self, state: TrainState, batcher: Iterable) -> dict:
        """Greedy-decode eval with corpus WER/CER. In a multi-process run
        each process decodes its own shard of the eval set and the counts
        (word and char edits and tokens, utterances, loss sum and batches)
        are summed over the processes (gather_eval_results), so WER, CER
        and num_utts are the whole set's."""
        hyps, refs, losses = [], [], []
        for batch in batcher:
            h, r, loss = self._decode(state, batch)
            hyps += h
            refs += r
            losses.append(loss)

        def counts(use_cer):
            edits = tokens = 0
            for h, r in zip(hyps, refs):
                h_l = list(h) if use_cer else h.split()
                r_l = list(r) if use_cer else r.split()
                edits += levenshtein(h_l, r_l)
                tokens += len(r_l)
            return edits, tokens

        (w_e, w_t), (c_e, c_t) = counts(False), counts(True)
        local = np.asarray(
            [w_e, w_t, c_e, c_t, len(hyps),
             float(np.sum(losses)) if losses else 0.0, len(losses)],
            np.float64)
        total = np.asarray(gather_eval_results(local))
        if total.ndim == 2:        # (processes, 7) in multi-process runs
            total = total.sum(axis=0)
        result = {
            "eval_loss": float(total[5] / max(total[6], 1)),
            "wer": float(total[0] / total[1]) if total[1] else float("inf"),
            "cer": float(total[2] / total[3]) if total[3] else float("inf"),
            "num_utts": int(total[4]),
        }
        self.history.append(result)
        return result
