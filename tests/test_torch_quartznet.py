"""vietasr_tpu_torch QuartzNet, config, weight loading and greedy decode vs
the JAX package's, on the CPU, on the same seeded weights and features."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietasr_tpu.config import BlockConfig as JaxBlock
from vietasr_tpu.config import EncoderConfig as JaxEncoder
from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.models.quartznet import fold_batchnorm as jax_fold
from vietasr_tpu.models.quartznet import init_quartznet as jax_init
from vietasr_tpu.models.quartznet import quartznet_apply as jax_apply
from vietasr_tpu.ops.greedy import greedy_decode as jax_greedy
from vietasr_tpu_torch.config import BlockConfig, EncoderConfig, load_config
from vietasr_tpu_torch.models.convert import (load_anchor, msgpack_restore,
                                              params_from_jax)
from vietasr_tpu_torch.models.quartznet import (_apply_block,
                                                _apply_block_ops,
                                                fold_batchnorm, map_tree,
                                                quartznet_apply)
from vietasr_tpu_torch.ops.greedy import (collapse_batch, ctc_collapse,
                                          greedy_decode, ids_to_text)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")

# a narrow 3-block QuartzNet with the shapes of 12x1's three kinds of block:
# strided separable, residual separable (kernel-eligible), dense 1x1
BLOCKS = [dict(filters=32, kernel=11, stride=2, residual=False,
               separable=True),
          dict(filters=32, kernel=9, stride=1, residual=True, separable=True),
          dict(filters=48, kernel=1, stride=1, residual=False,
               separable=False)]
FEAT_IN, N_CLASSES = 16, 10


def _narrow_variables(seed=0):
    """JAX-initialised variables with BN statistics and affine parameters
    drawn from a seed, as numpy arrays."""
    ecfg = JaxEncoder(blocks=tuple(JaxBlock(**b) for b in BLOCKS),
                      feat_in=FEAT_IN)
    variables = jax_init(jax.random.PRNGKey(seed), ecfg, N_CLASSES)
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return (rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)
        if "'mean'" in name or "'bias'" in name:
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, variables), ecfg


def _port_encoder():
    return EncoderConfig(blocks=tuple(BlockConfig(**b) for b in BLOCKS),
                         feat_in=FEAT_IN)


def _feats(bsz=3, t=96, seed=1):
    rng = np.random.RandomState(seed)
    feats = rng.randn(bsz, t, FEAT_IN).astype(np.float32)
    lens = np.array([t, t - 13, t // 2 + 1][:bsz], np.int32)
    return feats, lens


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y)
                                        for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_fold_batchnorm_matches_jax_exactly():
    variables, ecfg = _narrow_variables()
    want = jax.tree_util.tree_map(np.asarray, jax_fold(variables, ecfg))
    got = map_tree(lambda t: t.numpy(), fold_batchnorm(
        params_from_jax(variables, device="cpu"), _port_encoder()))
    assert _tree_equal(got, want)


@pytest.mark.parametrize("fold", [False, True])
def test_forward_fp32_matches_jax(fold):
    """fp32, unfolded (eval BN) and folded: max |d log p| <= 1e-4 (fp32
    sums in another order over 3 blocks), lengths equal."""
    variables, ecfg = _narrow_variables()
    if fold:
        variables = jax.tree_util.tree_map(np.asarray,
                                           jax_fold(variables, ecfg))
    feats, lens = _feats()
    want, want_lens, _ = jax_apply(variables, jnp.asarray(feats),
                                   jnp.asarray(lens), cfg=ecfg)
    got, got_lens = quartznet_apply(
        params_from_jax(variables, device="cpu"), torch.from_numpy(feats),
        torch.from_numpy(lens), cfg=_port_encoder())
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_forward_bf16_kernel_route_matches_jax_pallas_route():
    """bf16, folded: the port's kernel route (its plain version on the CPU)
    vs JAX's block_impl="pallas" (interpret mode on the CPU). The strided
    block and the dense 1x1 take per-op bf16 paths in both. Measured max
    |d log p| ~5e-7; the bound 1e-2 leaves room for one activation whose
    bf16 rounding falls the other way under another summation order."""
    variables, ecfg = _narrow_variables(seed=3)
    folded = jax.tree_util.tree_map(np.asarray, jax_fold(variables, ecfg))
    feats, lens = _feats(seed=4)
    want, want_lens, _ = jax_apply(folded, jnp.asarray(feats),
                                   jnp.asarray(lens), cfg=ecfg,
                                   compute_dtype=jnp.bfloat16,
                                   block_impl="pallas")
    got, got_lens = quartznet_apply(
        params_from_jax(folded, device="cpu"), torch.from_numpy(feats),
        torch.from_numpy(lens), cfg=_port_encoder(),
        compute_dtype=torch.bfloat16, block_impl="kernel")
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-2


def test_bf16_routes_agree():
    """The kernel route and its explicit plain version compute the same
    function in bf16, and the fused block agrees with the per-op block on
    the eligible block. The per-op block rounds the depthwise output to
    bf16 where the fused one keeps it fp32, and keeps the block output fp32
    where the fused one rounds it: measured max |d| ~2.2e-3 * max|want|,
    bound one bf16 step, 2^-7 * max|want|."""
    variables, ecfg = _narrow_variables(seed=5)
    folded = params_from_jax(jax_fold(variables, ecfg), device="cpu")
    feats, lens = (torch.from_numpy(a) for a in _feats(seed=6))
    cfg = _port_encoder()
    out = {impl: quartznet_apply(folded, feats, lens, cfg=cfg,
                                 compute_dtype=torch.bfloat16,
                                 block_impl=impl)[0]
           for impl in ("auto", "kernel", "plain")}
    assert torch.equal(out["auto"], out["kernel"])
    assert torch.equal(out["kernel"], out["plain"])
    params, stats = (folded[k]["encoder"] for k in ("params", "batch_stats"))
    (x,), lens, _ = _apply_block([feats], lens, params[0], stats[0],
                                 cfg.blocks[0], cfg, torch.bfloat16, "plain")
    (fused,), fused_lens, _ = _apply_block([x], lens, params[1], stats[1],
                                           cfg.blocks[1], cfg,
                                           torch.bfloat16, "plain")
    (ops,), ops_lens, _ = _apply_block_ops([x], lens, params[1], stats[1],
                                           cfg.blocks[1], cfg,
                                           torch.bfloat16)
    assert fused.dtype == torch.bfloat16 and torch.equal(fused_lens, ops_lens)
    assert float((fused.float() - ops).abs().max()) \
        <= 2.0 ** -7 * float(ops.abs().max())
    with pytest.raises(ValueError):
        quartznet_apply(folded, feats, lens, cfg=_port_encoder(),
                        block_impl="pallas")


def test_config_matches_jax_loader():
    got, want = load_config(CONFIG), jax_load_config(CONFIG)
    assert got.labels == want.labels and len(got.labels) == 90
    assert got.featurizer.__dict__ == want.featurizer.__dict__
    assert [b.__dict__ for b in got.encoder.blocks] \
        == [b.__dict__ for b in want.encoder.blocks]
    assert got.encoder.feat_in == want.encoder.feat_in == 64
    for b in got.encoder.blocks[1:14]:
        assert b.same_padding == b.effective_kernel // 2


def test_config_reproduces_anchor_tree():
    """The block list gives exactly the anchor's parameter tree."""
    cfg = jax_load_config(CONFIG)
    init = jax.eval_shape(lambda: jax_init(jax.random.PRNGKey(0),
                                           cfg.encoder, cfg.num_classes))
    anchor = load_anchor(ANCHOR)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), init)
    assert _tree_equal(map_tree(lambda a: np.array(a.shape), anchor),
                       map_tree(np.array, shapes))
    sizes = []
    map_tree(lambda a: sizes.append(a.size), anchor["params"])
    assert sum(sizes) == 5_109_147


def test_msgpack_decoder_scalars_and_containers():
    """Scalar, string and container encodings flax may write."""
    blob = bytes([0x85,                                   # map of 5
                  0xa1, 0x61, 0x93, 0x01, 0xff, 0xc0,     # "a": [1, -1, nil]
                  0xa1, 0x62, 0xcb]) \
        + np.float64(1.5).byteswap().tobytes() \
        + bytes([0xa1, 0x63, 0xc3,                        # "c": true
                 0xa1, 0x64, 0xd1, 0xfe, 0x0c,            # "d": int16 -500
                 0xa1, 0x65, 0x90])                       # "e": []
    assert msgpack_restore(blob) == {"a": [1, -1, None], "b": 1.5,
                                     "c": True, "d": -500, "e": []}
    with pytest.raises(ValueError):
        msgpack_restore(blob + b"\x00")


def test_greedy_decode_matches_jax():
    rng = np.random.RandomState(0)
    lp = rng.randint(0, 4, size=(3, 40, 6)).astype(np.float32)  # many ties
    lens = np.array([40, 25, 0], np.int32)
    want_p, want_k = jax_greedy(jnp.asarray(lp), jnp.asarray(lens), blank=5)
    got_p, got_k = greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens),
                                 blank=5)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    ids = collapse_batch(got_p, got_k)
    for row in range(3):
        raw = got_p[row, :lens[row]].tolist()
        assert ids[row].tolist() == ctc_collapse(raw, blank=5)
    assert ids_to_text([1, 0, 2], ["a", "b", "c"]) == "bac"
