"""A JAX TrainState resumed by the port (models/convert.py
assign_jax_opt_state, train/checkpoint.py CheckpointManager.restore,
cli.py train --work-dir), on the CPU.

For every optimizer the JAX package's make_optimizer builds (Novograd,
Adam, AdamW, SGD with momentum, with weight decay and with LARC, LAMB),
without and with grad_clip_norm's chain, JAX takes 2 train steps and
saves its TrainState through its CheckpointManager; the port restores
the file into a fresh TrainState and both take step 3 on the same batch.

Tolerances: loss 1e-5 relative, params 1e-6 absolute, BN stats 1e-6
relative (tests/test_torch_train.py's and test_torch_train_extras.py's
bars for a train step: the same fp32 formulas summed in another order).
"""

import os

import jax
import numpy as np
import pytest
import torch

from vietasr_tpu import cli as jax_cli
from vietasr_tpu.train import CheckpointManager as JaxCheckpoints
from vietasr_tpu.train import TrainState as JaxState
from vietasr_tpu.train import make_optimizer as jax_make_optimizer
from vietasr_tpu.train import make_schedule as jax_make_schedule
from vietasr_tpu.train import make_train_step as jax_make_train_step
from vietasr_tpu_torch import cli
from vietasr_tpu_torch.models.convert import jax_optimizer_kind
from vietasr_tpu_torch.train import (CheckpointManager, make_optimizer,
                                     make_schedule, make_train_step)
from vietasr_tpu_torch.train.loop import batch_to_tensors
from vietasr_tpu_torch.train.synthetic import SyntheticToneDataset

from test_torch_train import _configs, _jax_arrays, _jax_variables, _max_diff

torch.set_num_threads(1)

# (name, make_optimizer keywords, the JAX state's kind)
OPTIMIZERS = [("novograd", dict(weight_decay=0.001), "novograd"),
              ("adam", {}, "adam"),
              ("adamw", dict(weight_decay=0.01), "adamw"),
              ("sgd", {}, "sgd"),
              ("sgd", dict(weight_decay=0.001), "sgd"),
              ("sgd", dict(larc=True), "sgd"),
              ("lamb", dict(weight_decay=0.01), "lamb")]
LR = {"novograd": 0.01, "adam": 1e-3, "adamw": 1e-3, "sgd": 0.01,
      "lamb": 1e-3}


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("name,kw,kind", OPTIMIZERS,
                         ids=[f"{o[0]}{i}" for i, o in enumerate(OPTIMIZERS)])
def test_jax_train_state_resumes(tmp_path, name, kw, kind, clip):
    """Without clipping the learning rate is a schedule (optax keeps its
    count); with clipping a constant (an SGD keeps no count then: the
    port takes the steps taken less the skipped ones)."""
    jax_cfg, port_cfg = _configs()
    variables = _jax_variables(jax_cfg, seed=11)
    if clip is None:
        lr_j = jax_make_schedule("CosineAnnealing", LR[name], 10,
                                 warmup_steps=2)
        lr_p = make_schedule("CosineAnnealing", LR[name], 10,
                             warmup_steps=2)
    else:
        lr_j = lr_p = LR[name]
    jax_opt = jax_make_optimizer(name, lr_j, grad_clip_norm=clip, **kw)
    step = jax.jit(jax_make_train_step(jax_cfg, jax_opt, use_specaug=False,
                                       ctc_impl="pallas_interpret"))
    data = SyntheticToneDataset(seed=12)
    batches = [data.batch(4) for _ in range(3)]
    state = JaxState.create(variables, jax_opt)
    for i in range(2):
        state, _ = step(state, _jax_arrays(batches[i]), jax.random.PRNGKey(i))
    folder = str(tmp_path / "ckpt")
    JaxCheckpoints(folder).save(state)
    assert jax_optimizer_kind(state.opt_state)[0] == kind
    want, jax_m = step(state, _jax_arrays(batches[2]), jax.random.PRNGKey(2))

    from vietasr_tpu_torch.models.convert import train_state_from_jax

    fresh = train_state_from_jax(variables, optimizer=make_optimizer(
        name, lr_p, grad_clip_norm=clip, **kw), device="cpu")
    got = CheckpointManager(folder, device="cpu").restore(fresh)
    assert got is fresh and int(got.step) == 2
    assert int(got.optimizer.param_groups[0]["step"]) == 2
    got, m = make_train_step(port_cfg, use_specaug=False, ctc_impl="kernel",
                             device="cpu")(
        got, batch_to_tensors(batches[2], "cpu"), None)
    np.testing.assert_allclose(float(m["loss"]), float(jax_m["loss"]),
                               rtol=1e-5)
    assert _max_diff(want.params, got.params) <= 1e-6
    assert _max_diff(want.batch_stats, got.batch_stats, relative=True) <= 1e-6
    assert int(got.step) == 3 and int(got.skipped_steps) == 0


def test_mismatched_optimizer_raises_with_both_names(tmp_path):
    jax_cfg, _ = _configs()
    variables = _jax_variables(jax_cfg, seed=11)
    folder = str(tmp_path / "ckpt")
    JaxCheckpoints(folder).save(JaxState.create(
        variables, jax_make_optimizer("lamb", 1e-3)), 4)
    from vietasr_tpu_torch.models.convert import train_state_from_jax

    for port_name in ("novograd", "adam", "sgd"):
        fresh = train_state_from_jax(variables, optimizer=make_optimizer(
            port_name, 0.01), device="cpu")
        with pytest.raises(TypeError, match="JAX lamb state.*"
                           + {"novograd": "Novograd", "adam": "Adam",
                              "sgd": "SGD"}[port_name]):
            CheckpointManager(folder, device="cpu").restore(fresh)


def test_cli_train_resumes_a_jax_work_dir(tmp_path, capsys):
    """JAX's `cli train` writes state-STEP-<n>.msgpack into --work-dir;
    the port's `cli train` on the same folder resumes from it and goes
    on to step 2n, writing its own checkpoint."""
    from test_torch_cli import _config, _manifest

    cfg = _config(tmp_path)
    train = _manifest(tmp_path, "train", [0.6, 1.2, 0.9, 1.7], seed=4)
    work = str(tmp_path / "work")
    argv = ["train", "--config", cfg, "--train-manifest", train,
            "--work-dir", work, "--batch-size", "2", "--warmup-steps", "1",
            "--log-every", "1", "--lr", "0.01"]
    assert jax_cli.main(argv) == 0
    capsys.readouterr()
    (jax_ckpt,) = os.listdir(work)
    n = int(jax_ckpt.split("-")[-1].split(".")[0])
    assert jax_ckpt == f"state-STEP-{n}.msgpack" and n > 0
    assert cli.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert f"resumed from step {n}" in out
    assert f"done at step {2 * n}" in out
    assert f"state-STEP-{2 * n}.pt" in os.listdir(work)
