"""Command-line interface: transcribe / train / eval / serve (counterpart
of vietasr_tpu/cli.py, with its arguments and defaults).

    python -m vietasr_tpu_torch.cli [--device cuda|cpu] COMMAND ...

`--device` (default cuda) takes the JAX CLI's `--platform`: without a GPU
the default raises; `--device cpu` runs everything on the CPU (the tests
do). `--checkpoint-dir` reads the port's `state-STEP-<n>.pt` and the JAX
package's `state-STEP-<n>.msgpack` checkpoints (the newest). `train`
resumes from the newest checkpoint in `--work-dir`, the port's or the JAX
package's (its whole TrainState).

Multi-process training: start one process per GPU, each with
`--coordinator-address HOST:PORT --num-processes N --process-id I`
(a `file://` address also works). Process I takes `cuda:<I % GPUs>` and
joins an NCCL group (gloo with `--device cpu`); the processes train
data-parallel on the global batch of N x `--batch-size` rows
(train/loop.py), each reading and augmenting only its own rows
(audio/dataset.py RankBatcher; augmentor seed `seed + 1000 x I`, as in
JAX). Only process 0 writes checkpoints; every process resumes from the
same `--work-dir`. The eval set is sharded over the processes and its
counts summed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def _add_common_model_args(p: argparse.ArgumentParser):
    p.add_argument("--config", required=True, help="model YAML config")
    p.add_argument("--encoder-checkpoint", help="reference-format encoder .pt")
    p.add_argument("--decoder-checkpoint", help="reference-format decoder .pt")
    p.add_argument("--checkpoint-dir",
                   help="a folder of state-STEP-<n>.pt (this package) or "
                        ".msgpack (the JAX package) checkpoints")


def _checkpoint_variables(args, device):
    """{params, batch_stats} of the newest checkpoint in --checkpoint-dir."""
    from vietasr_tpu_torch.train.checkpoint import CheckpointManager

    variables = CheckpointManager(args.checkpoint_dir,
                                  device=device).restore_variables()
    if variables is None:
        raise FileNotFoundError(f"no checkpoints in {args.checkpoint_dir}")
    return variables


def _transcriber(args, device, options):
    from vietasr_tpu_torch.pipeline import Transcriber

    variables = (_checkpoint_variables(args, device)
                 if args.checkpoint_dir else None)
    return Transcriber(args.config,
                       encoder_checkpoint=args.encoder_checkpoint,
                       decoder_checkpoint=args.decoder_checkpoint,
                       variables=variables, options=options, device=device)


def cmd_transcribe(args) -> int:
    from vietasr_tpu_torch.audio.io import read_audio
    from vietasr_tpu_torch.pipeline import TranscriberOptions

    t = _transcriber(args, args.device, TranscriberOptions(
        beam_width=args.beam_width, lm_path=args.lm_path,
        lm_alpha=args.lm_alpha, lm_beta=args.lm_beta, decoder=args.decoder))
    paths = []
    for target in args.audio:
        if os.path.isdir(target):
            paths.extend(sorted(
                glob.glob(os.path.join(target, "*.wav"))
                + glob.glob(os.path.join(target, "*.mp3"))))
        else:
            paths.append(target)
    if not paths:
        print("no audio files found", file=sys.stderr)
        return 1
    signals, kept = [], []
    sr = t.cfg.featurizer.sample_rate
    for p in paths:
        samples, _ = read_audio(p, target_sr=sr)
        if args.max_duration and len(samples) > args.max_duration * sr:
            print(f"SKIP (> {args.max_duration}s): {p}", file=sys.stderr)
            continue
        signals.append(samples)
        kept.append(p)
    if args.int8:
        # static activation scales from the inputs themselves
        t.calibrate_int8(signals[: min(len(signals), 16)])
    t0 = time.time()
    texts = t.transcribe_batch(signals)
    wall = time.time() - t0
    audio_secs = sum(len(s) for s in signals) / sr
    for p, text in zip(kept, texts):
        print(json.dumps({"audio_filepath": p, "pred_text": text},
                         ensure_ascii=False))
    print(f"# {len(kept)} files, {audio_secs:.1f}s audio in {wall:.2f}s "
          f"({audio_secs / max(wall, 1e-9):.1f}x realtime)", file=sys.stderr)
    return 0


def build_augmentor(spec: str, seed: int = 0):
    """`--augment speed,gain,noise[:p]` -> (AudioAugmentor, bucket_margin),
    the JAX CLI's recipe: speed always on, gain / noise / shift at 0.7,
    every draw from one RandomState(seed); the margin covers the longest
    slowed waveform (speed 0.9 -> 1/0.9 longer)."""
    import numpy as np

    from vietasr_tpu_torch.audio.augment import (AudioAugmentor,
                                                 GainPerturbation,
                                                 ShiftPerturbation,
                                                 SpeedPerturbation,
                                                 WhiteNoisePerturbation)

    rng = np.random.RandomState(seed)
    margin = 1.0
    perturbations = []
    for item in spec.split(","):
        name, _, p = item.partition(":")
        name = name.strip().lower()
        prob = float(p) if p else None
        if name == "speed":
            perturbations.append((prob if prob is not None else 1.0,
                                  SpeedPerturbation(0.9, 1.1, rng=rng)))
            margin = max(margin, 1.0 / 0.9)
        elif name == "gain":
            perturbations.append((prob if prob is not None else 0.7,
                                  GainPerturbation(-6, 6, rng=rng)))
        elif name == "noise":
            perturbations.append((prob if prob is not None else 0.7,
                                  WhiteNoisePerturbation(-60, -38, rng=rng)))
        elif name == "shift":
            perturbations.append((prob if prob is not None else 0.7,
                                  ShiftPerturbation(rng=rng)))
        else:
            raise SystemExit(f"unknown --augment perturbation: {name!r}")
    return AudioAugmentor(perturbations=perturbations, rng=rng), margin


def train_batcher(cfg, manifest: str, batch_size: int, *, augment: str = "",
                  seed: int = 0, rank: int = 0, num_ranks: int = 1):
    """`train`'s BucketBatcher over `manifest`: the config's duration
    filters, silence trim and bucket bound, the `--augment` recipe (a fresh
    perturbation per read, so no two epochs see the same waveform) and its
    bucket margin, shuffled from `seed`. Across `num_ranks` processes,
    rank `rank`'s RankBatcher: its rows of the same global batches of
    batch_size x num_ranks rows, augmented from seed + 1000 x rank."""
    from vietasr_tpu_torch.audio import (AudioTextDataset, BucketBatcher,
                                         CharTokenizer, read_manifest)
    from vietasr_tpu_torch.audio.dataset import RankBatcher

    entries = read_manifest(manifest, min_duration=cfg.data.min_duration,
                            max_duration=cfg.data.max_duration)
    augmentor, bucket_margin = None, 1.0
    if augment:
        augmentor, bucket_margin = build_augmentor(augment,
                                                   seed=seed + 1000 * rank)
    ds = AudioTextDataset(entries, CharTokenizer(cfg.labels),
                          sample_rate=cfg.featurizer.sample_rate,
                          trim=cfg.data.trim_silence, augmentor=augmentor)
    kw = dict(max_duration=cfg.data.max_duration or 16.7, seed=seed,
              bucket_margin=bucket_margin)
    if num_ranks > 1:
        return RankBatcher(ds, batch_size, rank=rank, num_ranks=num_ranks,
                           **kw)
    return BucketBatcher(ds, batch_size, **kw)


def _train_device(args):
    """--device for this process: cuda:<process_id % GPUs> in a
    multi-process run on the GPU."""
    import torch

    from vietasr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda" and (args.num_processes or 1) > 1:
        device = torch.device(
            "cuda", (args.process_id or 0) % torch.cuda.device_count())
    return device


def cmd_train(args) -> int:
    import torch

    from vietasr_tpu_torch.audio import (AudioTextDataset, BucketBatcher,
                                         CharTokenizer, read_manifest)
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.models import model_init
    from vietasr_tpu_torch.parallel.distributed import (initialize_multihost,
                                                        is_main_process)
    from vietasr_tpu_torch.train import (CheckpointManager, TrainState,
                                         Trainer, make_optimizer,
                                         make_schedule)

    device = _train_device(args)
    topo = initialize_multihost(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id,
        device=device)
    rank, world = topo["process_index"], topo["process_count"]
    group = torch.distributed.group.WORLD if world > 1 else None
    cfg = load_config(args.config)
    tok = CharTokenizer(cfg.labels)
    batcher = train_batcher(cfg, args.train_manifest, args.batch_size,
                            augment=args.augment, seed=args.seed, rank=rank,
                            num_ranks=world)
    steps_per_epoch = max(batcher.steps_per_epoch(), 1)
    total = args.num_epochs * steps_per_epoch
    schedule = make_schedule(args.lr_policy, args.lr, total,
                             warmup_steps=args.warmup_steps)
    opt = make_optimizer(args.optimizer, schedule,
                         weight_decay=args.weight_decay,
                         grad_clip_norm=args.grad_clip)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState.create(model_init(generator, cfg, device=device), opt)

    cm = CheckpointManager(args.work_dir, keep=args.keep_checkpoints,
                           device=device)
    if cm.restore(state) is not None:
        print(f"resumed from step {int(state.step)}")

    eval_batcher = None
    if args.eval_manifest:
        eval_ds = AudioTextDataset(read_manifest(args.eval_manifest), tok,
                                   sample_rate=cfg.featurizer.sample_rate)
        eval_batcher = BucketBatcher(eval_ds, args.batch_size, shuffle=False,
                                     shard_id=rank, num_shards=world)

    trainer = Trainer(cfg=cfg, grad_accum=args.grad_accum,
                      lr_schedule=schedule, log_every=args.log_every,
                      eval_every=args.eval_every, checkpoint_manager=cm,
                      checkpoint_every=args.checkpoint_every, seed=args.seed,
                      compute_dtype=args.compute_dtype, device=device,
                      process_group=group)
    trainer.callbacks.append(
        lambda tr, m: print(json.dumps(m, ensure_ascii=False)))
    state = trainer.fit(state, batcher, num_epochs=args.num_epochs,
                        eval_batcher=eval_batcher)
    if is_main_process():
        cm.save(state)
    print(f"done at step {int(state.step)}")
    return 0


def cmd_serve(args) -> int:
    from vietasr_tpu_torch.pipeline import TranscriberOptions
    from vietasr_tpu_torch.serve.app import serve

    t = _transcriber(args, args.device, TranscriberOptions(
        beam_width=args.beam_width, lm_path=args.lm_path,
        lm_alpha=args.lm_alpha, lm_beta=args.lm_beta))
    pool = None
    if args.streaming:
        from vietasr_tpu_torch.serve.streams import StreamPool

        if t.cfg.architecture == "conformer":
            from vietasr_tpu_torch.streaming_conformer import \
                ConformerOnlineTranscriber as Online
        else:
            from vietasr_tpu_torch.streaming_online import \
                OnlineTranscriber as Online
        ot = Online(t.cfg, t._float_variables, device=t.device)
        pool = StreamPool(ot, slots=args.stream_slots,
                          decoder=args.stream_decoder,
                          beam_width=args.beam_width, lm_path=args.lm_path,
                          lm_alpha=args.lm_alpha, lm_beta=args.lm_beta)
    serve(t, host=args.host, port=args.port, record_dir=args.record_dir,
          stream_pool=pool)
    return 0


def cmd_eval(args) -> int:
    import torch

    from vietasr_tpu_torch.audio import (AudioTextDataset, BucketBatcher,
                                         CharTokenizer, read_manifest)
    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.models import model_init
    from vietasr_tpu_torch.models.convert import (params_from_jax,
                                                  variables_from_checkpoints)
    from vietasr_tpu_torch.train import TrainState, Trainer, make_optimizer
    from vietasr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.encoder_checkpoint and args.decoder_checkpoint:
        variables = params_from_jax(variables_from_checkpoints(
            args.encoder_checkpoint, args.decoder_checkpoint, cfg.encoder),
            device=device)
    elif args.checkpoint_dir:
        variables = _checkpoint_variables(args, device)
    else:
        variables = model_init(torch.Generator(device=device).manual_seed(0),
                               cfg, device=device)
    state = TrainState.create(variables, make_optimizer("sgd", 0.0))
    ds = AudioTextDataset(read_manifest(args.manifest),
                          CharTokenizer(cfg.labels),
                          sample_rate=cfg.featurizer.sample_rate)
    batcher = BucketBatcher(ds, args.batch_size, shuffle=False)
    result = Trainer(cfg=cfg, device=device).evaluate(state, batcher)
    print(json.dumps(result, ensure_ascii=False))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vietasr-torch",
        description="Vietnamese ASR on PyTorch / CUDA")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where everything runs (default cuda: raises "
                             "without a GPU)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("transcribe", help="transcribe wav files or a directory")
    _add_common_model_args(p)
    p.add_argument("audio", nargs="+", help="wav files or directories")
    p.add_argument("--beam-width", type=int, default=100)
    p.add_argument("--lm-path", help="ARPA/kenlm n-gram LM for beam search")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=1.5)
    p.add_argument("--decoder", default="greedy",
                   choices=["greedy", "beam", "device_beam"],
                   help="greedy | host C++ beam (+word LM) | on-device "
                        "batched beam (+LM)")
    p.add_argument("--int8", action="store_true",
                   help="serve the QuartzNet pointwise convs as calibrated "
                        "int8 GEMMs (calibrates on the inputs)")
    p.add_argument("--max-duration", type=float, default=0.0,
                   help="skip files longer than this many seconds (0 = no "
                        "skip)")
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("train", help="train from a JSON-lines manifest")
    _add_common_model_args(p)
    p.add_argument("--train-manifest", required=True)
    p.add_argument("--eval-manifest")
    p.add_argument("--work-dir", default="work")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--optimizer", default="novograd")
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--lr-policy", default="CosineAnnealing")
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--weight-decay", type=float, default=0.001)
    p.add_argument("--grad-clip", type=float, default=None)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--augment", default=None,
                   help="on-the-fly waveform perturbations, e.g. "
                        "'speed,gain,noise' or 'speed:1.0,gain:0.5'")
    p.add_argument("--compute-dtype", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="bf16 mixed precision")
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--keep-checkpoints", type=int, default=4)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("serve", help="web demo: upload + mic websocket")
    _add_common_model_args(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--record-dir", default=None,
                   help="save received audio here")
    p.add_argument("--streaming", action="store_true",
                   help="enable real-time partial-result websocket sessions")
    p.add_argument("--stream-slots", type=int, default=8)
    p.add_argument("--stream-decoder", choices=("greedy", "beam", "beam_host"),
                   default="greedy",
                   help="per-stream incremental decoder")
    p.add_argument("--beam-width", type=int, default=50)
    p.add_argument("--lm-path")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=1.5)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("eval", help="WER/CER over a labelled manifest")
    _add_common_model_args(p)
    p.add_argument("--manifest", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.set_defaults(fn=cmd_eval)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
