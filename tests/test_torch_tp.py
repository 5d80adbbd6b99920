"""vietasr_tpu_torch/parallel/tp.py: the Conformer tensor-parallel over
the 'model' axis of 2 gloo ranks (tests/torch_dist_worker.py), held
against the replicated forward and step and against the JAX package's TP
forward on its (data 2, model 4) mesh (tests/test_tp.py), on the CPU.

Tolerances: the forward 2e-4 (JAX's own TP bar; the ranks sum two
partial products where one process sums once, measured ~1e-6); a train
step's loss, gradient norm and update (params after - params before)
1e-5 relative, the update in its global norm; Novograd's per-tensor
second moments |g|^2 (a whole tensor's, all-reduced over the shards)
1e-5 relative in their global norm, and its update -lr x the first
moment 1e-5 relative on every leaf (the parameter after the step is
rounded to fp32 next to a value near 1, so its difference from the one
before carries an ulp of that value; the first moment does not). Left
out are the leaves whose replicated gradient norm is at most ZERO_GRAD
times the global norm: the key biases' gradient is zero but for
rounding (a per-query constant in the scores, which the softmax
removes), and Novograd's g / |g| turns that rounding into a full step in
a direction that differs between any two summation orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_worker as W
from vietasr_tpu.models.conformer import conformer_apply as jax_apply
from vietasr_tpu.models.conformer import init_conformer as jax_init
from vietasr_tpu.parallel import make_mesh as jax_make_mesh
from vietasr_tpu.parallel.tp import (conformer_tp_shardings,
                                     shard_conformer_variables as jax_shard)
from vietasr_tpu.config import ConformerConfig as JaxConformer
from vietasr_tpu_torch.models.conformer import conformer_apply
from vietasr_tpu_torch.models.convert import params_from_jax
from vietasr_tpu_torch.models.quartznet import tree_leaves, tree_paths
from vietasr_tpu_torch.parallel.tp import conformer_tp_spec, shard_leaf
from vietasr_tpu_torch.train.synthetic import SyntheticToneDataset

torch.set_num_threads(1)
WORLD = 2
OPTS = [("sgd", 0.05, 0.001), ("novograd", 0.01, 0.001)]
ZERO_GRAD = 1e-6


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = W.narrow_conformer_model()
    c = cfg.conformer
    jcfg = JaxConformer(num_blocks=c.num_blocks, d_model=c.d_model,
                        num_heads=c.num_heads, ff_expansion=c.ff_expansion,
                        conv_kernel=c.conv_kernel,
                        subsampling_channels=c.subsampling_channels,
                        dropout=0.0)
    jvars = jax_init(jax.random.PRNGKey(0), jcfg, feat_in=16,
                     num_classes=len(W.LABELS))
    variables = params_from_jax(jax.tree_util.tree_map(np.asarray, jvars),
                                device="cpu")
    rng = np.random.RandomState(0)
    feats = rng.randn(4, 32, 16).astype(np.float32)
    lens = np.array([32, 20, 32, 8], np.int32)
    b = SyntheticToneDataset(seed=5).batch(4)
    batch = {k: np.array(getattr(b, k)) for k in
             ("signal", "signal_lens", "tokens", "token_lens")}
    payload = {"variables": variables, "feats": feats, "lens": lens,
               "batch": batch, "opts": OPTS}
    ranks = W.run("tp", WORLD, str(tmp_path_factory.mktemp("tp")), payload)
    return cfg, jcfg, jvars, payload, ranks


def _jax_axis(spec):
    if spec == P(None, "model"):
        return 1
    if spec in (P("model"), P("model", None)):
        return 0
    assert spec == P()
    return None


def test_tp_spec_matches_jax(setup):
    """Every leaf's split, against JAX's conformer_tp_shardings, and
    tests/test_tp.py's spot checks."""
    _, _, jvars, payload, _ = setup
    shardings = conformer_tp_shardings(jvars, jax_make_mesh(2, 4))
    checked = 0
    for path, sharding in jax.tree_util.tree_leaves_with_path(shardings):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                        for k in path)
        assert conformer_tp_spec(name) == _jax_axis(sharding.spec), name
        checked += 1
    assert checked == len(tree_paths(payload["variables"]))
    blk = "params/blocks/0/"
    assert conformer_tp_spec(blk + "ff1/in/w") == 1
    assert conformer_tp_spec(blk + "ff1/out/w") == 0
    assert conformer_tp_spec(blk + "mhsa/q/w") == 1
    assert conformer_tp_spec(blk + "mhsa/out/w") == 0
    assert conformer_tp_spec(blk + "conv/dw") is None
    assert conformer_tp_spec("params/decoder/w") is None


def test_shards_are_the_ranks_slices(setup):
    _, _, _, payload, ranks = setup
    full = payload["variables"]
    for r, out in enumerate(ranks):
        for path, have, whole in zip(tree_paths(full),
                                     tree_leaves(out["shard"]),
                                     tree_leaves(full)):
            axis = conformer_tp_spec(path)
            assert torch.equal(have, shard_leaf(whole, axis, r, WORLD))
            if axis is not None:
                assert have.shape[axis] * WORLD == whole.shape[axis]
    w = ranks[0]["shard"]["params"]["blocks"][0]["mhsa"]["u"]
    assert w.shape[0] == 2          # 4 heads over 2 ranks


def test_tp_forward_matches_replicated_and_jax_tp(setup):
    cfg, jcfg, jvars, payload, ranks = setup
    feats = torch.from_numpy(payload["feats"])
    lens = torch.from_numpy(payload["lens"])
    with torch.no_grad():
        want_lp, want_lens = conformer_apply(payload["variables"], feats,
                                             lens, cfg=cfg.conformer)
    for out in ranks:
        assert torch.equal(out["lens"], want_lens)
        np.testing.assert_allclose(out["lp"].numpy(), want_lp.numpy(),
                                   atol=2e-4, rtol=2e-4)
    assert torch.equal(ranks[0]["lp"], ranks[1]["lp"])
    mesh = jax_make_mesh(num_data=2, num_model=4)
    fwd = jax.jit(lambda v, f, l: jax_apply(v, f, l, cfg=jcfg))
    with jax.set_mesh(mesh):
        jlp, jlens, _ = fwd(
            jax_shard(jvars, mesh),
            jax.device_put(jnp.asarray(payload["feats"]),
                           NamedSharding(mesh, P("data"))),
            jax.device_put(jnp.asarray(payload["lens"]),
                           NamedSharding(mesh, P("data"))))
    np.testing.assert_array_equal(ranks[0]["lens"].numpy(), np.asarray(jlens))
    np.testing.assert_allclose(ranks[0]["lp"].numpy(), np.asarray(jlp),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("opt", OPTS, ids=[o[0] for o in OPTS])
def test_tp_train_step_matches_replicated(setup, opt):
    cfg, _, _, payload, ranks = setup
    before = payload["variables"]["params"]
    want, loss, gn, want_m = W.tp_step(cfg, payload["variables"],
                                       payload["batch"], opt)
    paths = tree_paths(want)
    # leaves whose gradient is zero to rounding, by the replicated step's
    # per-tensor gradient norm (Novograd's first second moment is |g|^2)
    noise = {p for p in want_m if float(want_m[p][0]) ** 0.5 <= ZERO_GRAD * gn}
    kept = [p for p in paths if p not in noise]
    assert len(kept) >= len(paths) - 2     # at most the two key biases
    num, den = {p: 0.0 for p in paths}, {p: 0.0 for p in paths}
    m_num, m_den = {p: 0.0 for p in want_m}, {p: 0.0 for p in want_m}
    v_num = v_den = 0.0
    for r, out in enumerate(ranks):
        got, got_loss, got_gn, got_m = out[opt]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(got_gn, gn, rtol=1e-5)
        for path, g, w, b in zip(paths, tree_leaves(got),
                                 tree_leaves(want), tree_leaves(before)):
            axis = conformer_tp_spec(path)
            w_r, b_r = (shard_leaf(w, axis, r, WORLD),
                        shard_leaf(b, axis, r, WORLD))
            num[path] += float(((g - w_r).double() ** 2).sum())
            den[path] += float(((w_r - b_r).double() ** 2).sum())
        assert set(got_m) == set(want_m)
        for path, (v, m) in got_m.items():
            v_want, m_want = want_m[path]
            v_num += float((v - v_want).double() ** 2)
            v_den += float(v_want.double() ** 2)
            m_want = shard_leaf(m_want, conformer_tp_spec(path), r, WORLD)
            m_num[path] += float(((m - m_want).double() ** 2).sum())
            m_den[path] += float((m_want.double() ** 2).sum())
    # params after - params before, in the global norm of the leaves kept
    assert sum(den[p] for p in kept) > 0
    assert (sum(num[p] for p in kept) / sum(den[p] for p in kept)) ** 0.5 \
        <= 1e-5
    if opt[0] == "sgd":
        return
    assert v_den > 0 and (v_num / v_den) ** 0.5 <= 1e-5
    # Novograd's update is -lr x its first moment (g / |g| + wd p on the
    # first step): leaf by leaf, as the optimizer adds it to the parameter
    for p in kept:
        assert m_den[p] > 0 and (m_num[p] / m_den[p]) ** 0.5 <= 1e-5, p
