"""vietasr_tpu_torch/parallel/ and the data-parallel train step on
torch.distributed, held against the one-process step and against the JAX
package's sharded step (tests/test_parallel.py), on the CPU.

The multi-process cases run in 2 gloo ranks spawned by
tests/torch_dist_worker.py (one spawn per case, each joined within its
own time limit); the JAX side runs here, on conftest's 8 CPU devices.

Tolerances, each with its reason:
- 2 ranks vs each other: bit for bit (every rank reduces the same sums
  and applies the same update).
- 2 ranks vs the one-process step on the global batch, after 3 steps:
  1e-5 relative in the global norm of each tree (params, batch stats,
  optimizer state). The ranks sum two partial sums where one process sums
  once, so the BN statistics, the loss and the gradients differ in the
  last bits, and Novograd's per-tensor normalization carries that into
  every update.
- the one-process step vs JAX's 8-device sharded step: the tolerances of
  tests/test_torch_train.py's step comparison (loss and grad norm 1e-5
  relative, params 1e-6 absolute, BN stats 1e-6 relative).
- the global BN statistics vs JAX's BN on the whole batch: 1e-6, as
  test_torch_train.py's BN comparison.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as W
from vietasr_tpu.config import BlockConfig as JaxBlock
from vietasr_tpu.config import DataConfig as JaxData
from vietasr_tpu.config import EncoderConfig as JaxEncoder
from vietasr_tpu.config import ModelConfig as JaxModel
from vietasr_tpu.config import SpecAugmentConfig as JaxSpecAug
from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeat
from vietasr_tpu.models.layers import batchnorm_apply as jax_bn
from vietasr_tpu.models.quartznet import init_quartznet as jax_init
from vietasr_tpu.parallel import make_mesh as jax_make_mesh
from vietasr_tpu.parallel import replicate as jax_replicate
from vietasr_tpu.parallel import shard_batch as jax_shard_batch
from vietasr_tpu.train import TrainState as JaxState
from vietasr_tpu.train import make_optimizer as jax_make_optimizer
from vietasr_tpu.train import make_train_step as jax_make_train_step
from vietasr_tpu_torch.audio.dataset import BucketBatcher, RankBatcher
from vietasr_tpu_torch.models.convert import to_numpy
from vietasr_tpu_torch.models.quartznet import tree_leaves
from vietasr_tpu_torch.train.synthetic import SyntheticToneDataset

torch.set_num_threads(1)
WORLD = 2
OPT = ("novograd", 0.01, 0.001)


def _jax_cfg():
    return JaxModel(name="narrow", labels=W.LABELS,
                    featurizer=JaxFeat(features=16, dither=0.0, pad_to=8),
                    encoder=JaxEncoder(blocks=tuple(JaxBlock(**b)
                                                    for b in W.BLOCKS),
                                       feat_in=16),
                    spec_augment=JaxSpecAug(), data=JaxData())


def _variables():
    cfg = _jax_cfg()
    return jax.tree_util.tree_map(np.asarray, jax_init(
        jax.random.PRNGKey(0), cfg.encoder, cfg.num_classes))


def _batch(seed, pad_rows=(), nan_row=None):
    """8 synthetic rows as a dict; `pad_rows` zero-length (a bucket's
    padding: signal, lengths and tokens zero)."""
    b = SyntheticToneDataset(seed=seed).batch(8)
    out = {k: np.array(getattr(b, k)) for k in
           ("signal", "signal_lens", "tokens", "token_lens")}
    for r in pad_rows:
        for k in out:
            out[k][r] = 0
    if nan_row is not None:
        out["signal"][nan_row, 0] = np.nan
    return out


def _interleave(b, world, accum):
    """The global batch whose microbatch k is the union of the ranks'
    microbatches k (each rank holding contiguous rows)."""
    n = b["signal"].shape[0]
    per, m = n // world, n // world // accum
    order = [r * per + k * m + i for k in range(accum)
             for r in range(world) for i in range(m)]
    return {k: v[order] for k, v in b.items()}


def _rel(a, b):
    """|a - b| / |b| over every leaf of two trees (global norms)."""
    la = [t.double() for t in tree_leaves(a)]
    lb = [t.double() for t in tree_leaves(b)]
    num = sum(float(((x - y) ** 2).sum()) for x, y in zip(la, lb))
    den = sum(float((y ** 2).sum()) for y in lb)
    return (num / max(den, 1e-30)) ** 0.5


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


RUNS = {
    # zero-length rows all on rank 1: the ranks' valid counts are 4 and 2
    "uneven": ([_batch(s, pad_rows=(5, 6)) for s in (0, 1, 2)], 1, OPT),
    "accum2": ([_batch(s, pad_rows=(7,)) for s in (3, 4, 5)], 2, OPT),
    "nan": ([_batch(6, nan_row=5)], 1, ("sgd", 0.01, 0.0)),
}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    rng = np.random.RandomState(9)
    payload = {"variables": _variables(), "runs": RUNS,
               "bn_x": rng.randn(8, 6, 5).astype(np.float32) * 2 + 1,
               "bn_w": rng.randn(8, 6, 5).astype(np.float32),
               "bn_params": {"scale": rng.rand(5).astype(np.float32) + 0.5,
                             "bias": rng.randn(5).astype(np.float32)},
               "bn_stats": {"mean": rng.randn(5).astype(np.float32),
                            "var": rng.rand(5).astype(np.float32) + 0.5}}
    ranks = W.run("dp", WORLD, str(tmp_path_factory.mktemp("dp")), payload)
    return payload, ranks


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    return W.run("helpers", WORLD, str(tmp_path_factory.mktemp("helpers")))


def test_make_mesh_shapes_and_error(helpers):
    for r, out in enumerate(helpers):
        assert out["mesh"] == ((WORLD, 1), ("data", "model"))
        assert out["mesh_1x2"] == (1, WORLD)
        assert out["mesh_error"] == f"mesh 2x2 != {WORLD} devices"
        assert torch.equal(out["shard"]["x"],
                           torch.arange(16.0).reshape(8, 2)[4 * r: 4 * r + 4])
        assert int(out["shard"]["n"]) == 3
        assert torch.equal(out["replicated"]["w"][0], torch.zeros(3))


def test_distributed_helpers(helpers):
    for r, out in enumerate(helpers):
        assert out["topo"] == {"process_index": r, "process_count": WORLD,
                               "local_devices": 1, "global_devices": WORLD}
        assert out["broadcast"] == "from-rank-0-ắ"
        assert out["barrier_raised"] is True
        np.testing.assert_array_equal(
            out["gathered"], [[10.0, 2.0], [11.0, 2.0]])


def test_rank_batchers_split_the_global_batches(helpers):
    """Every rank takes the same number of batches in the same buckets;
    their rows are disjoint, and their union at step i is the
    one-process BucketBatcher's batch i at the global batch size."""
    a, b = helpers[0]["rank_batches"], helpers[1]["rank_batches"]
    assert len(a) == len(b) > 0
    one = BucketBatcher(W.ToyDataset(), 2 * WORLD, buckets=[16000, 32000], seed=3)
    want = [[int(x.signal[r, 0]) - 1 if x.signal_lens[r] else -1
             for r in range(x.signal.shape[0])]
            for epoch in range(2) for x in one]
    assert len(want) == len(a)
    for (sa, ra), (sb, rb), w in zip(a, b, want):
        assert sa == sb and sa[0] == 2
        assert ra + rb == w
        real = [i for i in ra + rb if i >= 0]
        assert len(real) == len(set(real))
    rank1 = RankBatcher(W.ToyDataset(), 2, rank=1, num_ranks=2,
                        buckets=[16000, 32000], seed=3)
    assert [x.signal.shape for x in rank1] == [s for s, _ in b[:len(b) // 2]]


@pytest.mark.parametrize("name", ["uneven", "accum2"])
def test_dp_step_equals_the_global_batch_step(dp, name):
    payload, ranks = dp
    batches, accum, opt = RUNS[name]
    r0, r1 = ranks[0][name], ranks[1][name]
    for key in ("params", "batch_stats", "opt_state"):
        assert _equal(r0[key], r1[key]), f"{name}: ranks differ in {key}"
    assert r0["hist"] == r1["hist"] and r0["skipped"] == 0
    ref = W.dp_run(W.narrow_quartznet(), payload["variables"],
                   [_interleave(b, WORLD, accum) for b in batches],
                   opt=opt, grad_accum=accum)
    for key in ("params", "batch_stats", "opt_state"):
        rel = _rel(r0[key], ref[key])
        assert rel <= 1e-5, f"{name}: {key} {rel:.3e} from one process"
    np.testing.assert_allclose(np.array(r0["hist"]), np.array(ref["hist"]),
                               rtol=1e-5)
    assert r0["count"] == ref["count"] == len(batches)


def test_dp_nan_on_one_rank_skips_on_both(dp):
    payload, ranks = dp
    for out in ranks:
        got = out["nan"]
        assert got["skipped"] == 1 and got["count"] == 0
        assert not np.isfinite(got["hist"][0][1])
        want = {"params": payload["variables"]["params"],
                "batch_stats": payload["variables"]["batch_stats"]}
        for key in want:
            for a, b in zip(tree_leaves(to_numpy(got[key])),
                            jax.tree_util.tree_leaves(want[key])):
                np.testing.assert_array_equal(a, b)


def test_global_batch_stats_match_jax_bn(dp):
    """batchnorm_apply with a group: each rank's rows normalized by the
    whole batch's statistics, the running stats and the input gradient
    equal JAX's BN (and its gradient) on the whole batch."""
    payload, ranks = dp
    x = jnp.asarray(payload["bn_x"])
    params = {k: jnp.asarray(v) for k, v in payload["bn_params"].items()}
    stats = {k: jnp.asarray(v) for k, v in payload["bn_stats"].items()}

    def f(x):
        y, new = jax_bn(x, params, stats, training=True)
        return jnp.sum(y * payload["bn_w"]), (y, new)

    (_, (want_y, want_new)), want_g = jax.value_and_grad(f, has_aux=True)(x)
    got_y = np.concatenate([r["bn"][0].numpy() for r in ranks])
    got_g = np.concatenate([r["bn"][2].numpy() for r in ranks])
    np.testing.assert_allclose(got_y, np.asarray(want_y), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r["bn"][1][k].numpy(),
                                       np.asarray(want_new[k]), rtol=1e-6)


def test_one_process_step_matches_jax_sharded_step():
    """tests/test_parallel.py's check, against the port: JAX's step over
    its 8 CPU devices (one row each) and the port's one-process step on
    the same global batch (zero-length rows included)."""
    variables = _variables()
    batch = _batch(0, pad_rows=(5, 6))
    jax_opt = jax_make_optimizer(*OPT[:2], weight_decay=OPT[2])
    step = jax_make_train_step(_jax_cfg(), jax_opt, use_specaug=False,
                               ctc_impl="pallas_interpret")
    mesh = jax_make_mesh()
    state = jax_replicate(mesh, JaxState.create(variables, jax_opt))
    sharded = jax_shard_batch(mesh, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    with jax.set_mesh(mesh):
        state, m = jax.jit(step)(state, sharded, jax.random.PRNGKey(0))
    got = W.dp_run(W.narrow_quartznet(), variables, [batch], opt=OPT)
    loss, gn = got["hist"][0]
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(gn, float(m["grad_norm"]), rtol=1e-5)
    for want, have in zip(jax.tree_util.tree_leaves(state.params),
                          tree_leaves(to_numpy(got["params"]))):
        np.testing.assert_allclose(have, np.asarray(want), atol=1e-6)
    for want, have in zip(jax.tree_util.tree_leaves(state.batch_stats),
                          tree_leaves(to_numpy(got["batch_stats"]))):
        np.testing.assert_allclose(have, np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# cli train across 2 processes


def test_cli_train_two_processes(tmp_path, capsys):
    """`cli train --num-processes 2` (gloo, --device cpu) over a manifest
    whose per-shard BucketBatchers would take 4 and 5 steps: both ranks
    take the same steps and one checkpoint is written (by rank 0). The
    trainer's periodic eval (--eval-every) over the sharded eval set
    counts every utterance once on both ranks, and `cli eval` on the
    checkpoint counts the eval manifest's utterances."""
    from vietasr_tpu_torch import cli
    from vietasr_tpu_torch.audio import (AudioTextDataset, CharTokenizer,
                                         read_manifest)
    from vietasr_tpu_torch.config import load_config

    from test_torch_cli import _config, _json_lines, _manifest

    cfg_path = _config(tmp_path)
    durations = [2.7, 2.3, 1.5, 2.3, 0.6, 1.9, 0.7, 2.7, 1.6, 1.3]
    train = _manifest(tmp_path, "train", durations, seed=0)
    evalm = _manifest(tmp_path, "eval", [0.8, 1.3, 0.7, 0.6, 1.1], seed=20)
    cfg = load_config(cfg_path)
    ds = AudioTextDataset(read_manifest(train), CharTokenizer(cfg.labels),
                          sample_rate=16000)
    per_shard = [sum(1 for _ in BucketBatcher(ds, 2, max_duration=3.0,
                                              seed=0, shard_id=s,
                                              num_shards=2))
                 for s in range(2)]
    assert per_shard == [4, 5]
    one = sum(1 for _ in BucketBatcher(ds, 2 * WORLD, max_duration=3.0,
                                       seed=0))
    work = str(tmp_path / "work")
    argv = ["--device", "cpu", "train", "--config", cfg_path,
            "--train-manifest", train, "--eval-manifest", evalm,
            "--work-dir", work, "--batch-size", "2", "--warmup-steps", "1",
            "--augment", "speed,gain", "--log-every", "1", "--lr", "0.01",
            "--eval-every", str(one)]
    ranks = W.run("cli", WORLD, str(tmp_path / "dist"), {"argv": argv})
    steps = []
    for r in ranks:
        assert r["rc"] == 0
        lines = [json.loads(l) for l in r["stdout"].splitlines()
                 if l.startswith("{")]
        steps.append([(m["step"], m["loss"]) for m in lines if "loss" in m])
        assert len(r["evals"]) == 1 and r["evals"][0]["num_utts"] == 5
    assert ranks[0]["evals"] == ranks[1]["evals"]
    assert [s for s, _ in steps[0]] == [s for s, _ in steps[1]] \
        == list(range(1, one + 1))
    assert steps[0] == steps[1]             # the same global loss
    assert os.listdir(work) == [f"state-STEP-{one}.pt"]

    assert cli.main(["--device", "cpu", "eval", "--config", cfg_path,
                     "--checkpoint-dir", work, "--manifest", evalm,
                     "--batch-size", "2"]) == 0
    result = _json_lines(capsys.readouterr().out)[-1]
    assert result["num_utts"] == 5
