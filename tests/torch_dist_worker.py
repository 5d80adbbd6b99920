"""Multi-process cases for the port's parallel/ tests: each case runs in
`world` gloo ranks spawned with torch.multiprocessing on the CPU, joined
through a file:// store, and saves what it computed per rank for the
test process to check. This module imports torch and the port only (the
JAX side of each comparison runs in the test's own process).

run(case, world, tmp, payload) starts the ranks, joins them within a time
limit of its own (killing them on expiry, so a hang fails one test) and
returns the ranks' results, or raises with the failing rank's traceback.
"""

import io
import os
import sys
import time
import traceback

import numpy as np
import torch

JOIN_SECONDS = 240.0


def run(case: str, world: int, tmp: str, payload=None) -> list:
    ctx = torch.multiprocessing.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, f"{case}.store")
    if os.path.exists(store):
        os.remove(store)
    if payload is not None:
        torch.save(payload, os.path.join(tmp, f"{case}.in"))
    procs = [ctx.Process(target=_entry, args=(case, r, world, tmp),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_SECONDS
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    errors = []
    for r in range(world):
        err = os.path.join(tmp, f"{case}.{r}.err")
        if os.path.exists(err):
            with open(err, encoding="utf-8") as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode for p in procs):
        raise RuntimeError(
            f"{case}: {len(hung)} rank(s) killed after {JOIN_SECONDS} s, "
            f"exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"{case}.{r}.out"),
                       weights_only=False) for r in range(world)]


def _entry(case, rank, world, tmp):
    torch.set_num_threads(1)
    try:
        src = os.path.join(tmp, f"{case}.in")
        payload = torch.load(src, weights_only=False) \
            if os.path.exists(src) else None
        store = "file://" + os.path.join(tmp, f"{case}.store")
        out = CASES[case](rank, world, store, payload)
        torch.save(out, os.path.join(tmp, f"{case}.{rank}.out"))
    except BaseException:
        with open(os.path.join(tmp, f"{case}.{rank}.err"), "w",
                  encoding="utf-8") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _join(store, rank, world):
    from vietasr_tpu_torch.parallel import initialize_multihost

    return initialize_multihost(store, world, rank, device="cpu")


# ---------------------------------------------------------------------------
# the distributed helpers, after tests/multiproc_worker.py


class _Entry:
    def __init__(self, duration):
        self.duration = duration


class ToyDataset:
    """11 utterances in two 1 s buckets, duck-typing AudioTextDataset;
    sample i is constant-valued i + 1, so a batch shows which indices it
    holds."""

    sample_rate = 16000
    durations = [0.5, 1.5, 0.7, 0.4, 1.8, 1.2, 0.9, 0.3, 1.9, 0.6, 1.1]
    entries = [_Entry(d) for d in durations]

    def __len__(self):
        return len(self.durations)

    def max_token_len(self):
        return 4

    def __getitem__(self, i):
        return (np.full(int(self.durations[i] * 16000), float(i + 1),
                        np.float32), np.array([1, 2], np.int32))


def case_helpers(rank, world, store, payload):
    from vietasr_tpu_torch.audio.dataset import RankBatcher
    from vietasr_tpu_torch.parallel import (broadcast_string,
                                            gather_eval_results, make_mesh,
                                            replicate, shard_batch,
                                            sync_all_processes)

    out = {"topo": _join(store, rank, world)}
    out["broadcast"] = broadcast_string(f"from-rank-{rank}-ắ")
    sync_all_processes(True)
    try:
        sync_all_processes(rank != world - 1)
        out["barrier_raised"] = False
    except RuntimeError as e:
        out["barrier_raised"] = "at least one process" in str(e)
    mesh = make_mesh()
    out["mesh"] = tuple(mesh.mesh.shape), mesh.mesh_dim_names
    out["mesh_1x2"] = tuple(make_mesh(num_data=1, num_model=world)
                            .mesh.shape)
    try:
        make_mesh(num_data=2, num_model=2)
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)
    rows = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    out["shard"] = shard_batch(mesh, {"x": rows, "n": torch.tensor(3)})
    out["replicated"] = replicate(mesh, {"w": [torch.full((3,), rank)]})

    batcher = RankBatcher(ToyDataset(), 2, rank=rank, num_ranks=world,
                          buckets=[16000, 32000], seed=3)
    out["rank_batches"] = [
        (b.signal.shape, [int(b.signal[r, 0]) - 1 if b.signal_lens[r] else -1
                          for r in range(b.signal.shape[0])])
        for epoch in range(2) for b in batcher]
    out["gathered"] = gather_eval_results(
        np.asarray([10.0 + rank, 2.0], np.float64))
    return out


# ---------------------------------------------------------------------------
# the data-parallel train step

LABELS = [" ", "a", "b", "c"]
BLOCKS = [dict(filters=32, kernel=11, stride=2, residual=False,
               separable=True),
          dict(filters=32, kernel=9, stride=1, residual=True, separable=True),
          dict(filters=48, kernel=1, stride=1, residual=False,
               separable=False)]


def narrow_quartznet():
    """tests/test_torch_train.py's narrow QuartzNet, dither 0."""
    from vietasr_tpu_torch.config import (BlockConfig, EncoderConfig,
                                          ModelConfig, SpecAugmentConfig)
    from vietasr_tpu_torch.frontend.features import FeaturizerConfig

    return ModelConfig(
        name="narrow", labels=LABELS,
        featurizer=FeaturizerConfig(features=16, dither=0.0, pad_to=8),
        encoder=EncoderConfig(blocks=tuple(BlockConfig(**b) for b in BLOCKS),
                              feat_in=16),
        spec_augment=SpecAugmentConfig())


def dp_run(cfg, variables, batches, *, opt, grad_accum=1, group=None):
    """Train steps from `variables` over `batches` (dicts of numpy arrays):
    (params, batch_stats, optimizer state, [(loss, grad_norm)],
    skipped)."""
    from vietasr_tpu_torch.models.convert import train_state_from_jax
    from vietasr_tpu_torch.models.quartznet import map_tree, tree_paths
    from vietasr_tpu_torch.train import make_optimizer, make_train_step

    name, lr, wd = opt
    state = train_state_from_jax(variables, optimizer=make_optimizer(
        name, lr, weight_decay=wd), device="cpu")
    step = make_train_step(cfg, use_specaug=False, grad_accum=grad_accum,
                           ctc_impl="kernel", device="cpu", group=group)
    hist = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in b.items()}, None)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    opt_state = {path: {k: v.clone() for k, v in
                        state.optimizer.state[p].items()}
                 for path, p in zip(tree_paths(state.params),
                                    state.param_list())}
    return {"params": map_tree(lambda t: t.detach().clone(), state.params),
            "batch_stats": map_tree(torch.clone, state.batch_stats),
            "opt_state": opt_state, "hist": hist,
            "skipped": int(state.skipped_steps),
            "count": int(state.optimizer.param_groups[0]["step"])}


def case_dp(rank, world, store, payload):
    """Each sub-case's global batches are split into contiguous per-rank
    rows (payload["runs"][name] = (batches, grad_accum, opt)); plus one
    BN layer on the global statistics."""
    import torch.distributed as dist

    from vietasr_tpu_torch.models.layers import batchnorm_apply

    _join(store, rank, world)
    group = dist.group.WORLD
    cfg = narrow_quartznet()
    out = {}
    for name, (batches, grad_accum, opt) in payload["runs"].items():
        local = []
        for b in batches:
            n = b["signal"].shape[0] // world
            local.append({k: v[rank * n:(rank + 1) * n] for k, v in b.items()})
        out[name] = dp_run(cfg, payload["variables"], local, opt=opt,
                           grad_accum=grad_accum, group=group)
    x = torch.from_numpy(payload["bn_x"])
    n = x.shape[0] // world
    xl = x[rank * n:(rank + 1) * n].clone().requires_grad_(True)
    params = {k: torch.from_numpy(v) for k, v in payload["bn_params"].items()}
    stats = {k: torch.from_numpy(v) for k, v in payload["bn_stats"].items()}
    y, new = batchnorm_apply(xl, params, stats, training=True, group=group)
    # the gradient of sum(y * w) over the global batch: each rank's share
    w = torch.from_numpy(payload["bn_w"])[rank * n:(rank + 1) * n]
    (y * w).sum().backward()
    out["bn"] = (y.detach(), new, xl.grad)
    return out


# ---------------------------------------------------------------------------
# cli train across processes


def case_cli(rank, world, store, payload):
    import contextlib

    from vietasr_tpu_torch import cli
    from vietasr_tpu_torch.train import Trainer

    evals = []
    evaluate = Trainer.evaluate

    def recorded(self, state, batcher):
        evals.append(evaluate(self, state, batcher))
        return evals[-1]

    Trainer.evaluate = recorded
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(payload["argv"] + [
            "--coordinator-address", store, "--num-processes", str(world),
            "--process-id", str(rank)])
    return {"rc": rc, "stdout": buf.getvalue(), "evals": evals}


# ---------------------------------------------------------------------------
# tensor parallelism


def narrow_conformer_model():
    """tests/test_tp.py's Conformer as a ModelConfig (16 features)."""
    from vietasr_tpu_torch.config import (ConformerConfig, EncoderConfig,
                                          ModelConfig, SpecAugmentConfig)
    from vietasr_tpu_torch.frontend.features import FeaturizerConfig

    conf = ConformerConfig(num_blocks=2, d_model=32, num_heads=4,
                           ff_expansion=2, conv_kernel=7,
                           subsampling_channels=8, dropout=0.0)
    return ModelConfig(
        name="tp-conf", labels=LABELS,
        featurizer=FeaturizerConfig(features=16, dither=0.0, pad_to=8),
        encoder=EncoderConfig(blocks=(), feat_in=16),
        spec_augment=SpecAugmentConfig(), architecture="conformer",
        conformer=conf)


def tp_step(cfg, variables, batch, opt, *, mesh=None):
    """One train step, tensor-parallel over mesh's 'model' axis when given:
    (params after, loss, grad_norm, {path: (the optimizer's per-tensor
    second moment, its first moment)} for Novograd)."""
    from vietasr_tpu_torch.models.quartznet import map_tree, tree_paths
    from vietasr_tpu_torch.parallel.tp import shard_conformer_variables
    from vietasr_tpu_torch.train import (TrainState, make_optimizer,
                                         make_train_step)

    tp_group = None
    if mesh is not None:
        variables = shard_conformer_variables(variables, mesh)
        tp_group = mesh.get_group("model")
    name, lr, wd = opt
    state = TrainState.create(variables, make_optimizer(name, lr,
                                                        weight_decay=wd))
    step = make_train_step(cfg, use_specaug=False, device="cpu",
                           tp_group=tp_group)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                    None)
    moments = {path: (state.optimizer.state[p]["exp_avg_sq"].clone(),
                      state.optimizer.state[p]["exp_avg"].clone())
               for path, p in zip(tree_paths(state.params),
                                  state.param_list())
               if "exp_avg_sq" in state.optimizer.state[p]}
    return (map_tree(lambda t: t.detach().clone(), state.params),
            float(m["loss"]), float(m["grad_norm"]), moments)


def case_tp(rank, world, store, payload):
    from vietasr_tpu_torch.models.conformer import conformer_apply
    from vietasr_tpu_torch.parallel import make_mesh
    from vietasr_tpu_torch.parallel.tp import shard_conformer_variables

    _join(store, rank, world)
    mesh = make_mesh(num_data=1, num_model=world)
    cfg = narrow_conformer_model()
    variables = payload["variables"]
    shard = shard_conformer_variables(variables, mesh)
    feats = torch.from_numpy(payload["feats"])
    lens = torch.from_numpy(payload["lens"])
    with torch.no_grad():
        lp, out_lens = conformer_apply(shard, feats, lens, cfg=cfg.conformer,
                                       tp_group=mesh.get_group("model"))
    out = {"lp": lp, "lens": out_lens, "shard": shard}
    for opt in payload["opts"]:
        out[opt] = tp_step(cfg, variables, payload["batch"], opt, mesh=mesh)
    return out


def case_logging(rank, world, store, payload):
    """utils/logging.py and utils/exp_manager.py under a process group: the
    logger's rank, its console and per-rank file, and an ExpManager with
    a timestamp every rank shares, written by rank 0 only."""
    import logging

    from vietasr_tpu_torch.utils import ExpManager, get_logger
    from vietasr_tpu_torch.utils.logging import _process_index

    os.environ["RANK"] = "7"         # the group's rank takes precedence
    _join(store, rank, world)
    logger = get_logger(log_file=os.path.join(payload["dir"], "log-%r.txt"))
    logger.info("hello from rank %d", rank)
    for h in logger.handlers:
        h.flush()
    exp = ExpManager(os.path.join(payload["dir"], "exp"))
    exp.log_metrics({"loss": 1.5 + rank}, step=rank)
    exp.close()
    return {"rank": _process_index(),
            "console": sum(type(h) is logging.StreamHandler
                           for h in logger.handlers),
            "work_dir": exp.work_dir, "is_main": exp.is_main}


CASES = {"helpers": case_helpers, "dp": case_dp, "cli": case_cli,
         "tp": case_tp, "logging": case_logging}


if __name__ == "__main__":
    sys.exit("run through tests/test_torch_parallel.py")
