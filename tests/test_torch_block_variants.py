"""vietasr_tpu_torch's QuartzNet/Jasper block variants (grouped separable
1x1s with channel shuffle, heads, squeeze-excite, dense residual,
residual_mode="max", hardtanh and selu, stride and dilation) vs the JAX
package's `quartznet_apply` (its XLA route) on the CPU, on the same seeded
numpy inputs and JAX-initialised weights (through `params_from_jax`).

Tolerances, each with its reason:
- fp32 eval log-probs: 1e-4 absolute (fp32 sums in another order over 4-5
  blocks; the measured distance is ~1e-6).
- training mode (batch-stat BN, dropout 0): log-probs, new BN stats and
  the gradients of a seeded linear function of the log-probs within 1e-4
  relative to the largest entry of each leaf.
- fold_batchnorm: each folded leaf within 2 ulp (fp32) of the fold done in
  fp64 (one multiply and one divide of a square root, each rounded).
- bf16 per-op log-probs: 1e-2, the bound tests/test_torch_quartznet.py
  holds bf16 to against JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vietasr_tpu.config import BlockConfig as JaxBlock
from vietasr_tpu.config import EncoderConfig as JaxEncoder
from vietasr_tpu.models.quantize import \
    calibrate_activations as jax_calibrate
from vietasr_tpu.models.quartznet import fold_batchnorm as jax_fold
from vietasr_tpu.models.quartznet import init_quartznet as jax_init
from vietasr_tpu.models.quartznet import quartznet_apply as jax_apply
from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch.config import BlockConfig, EncoderConfig, load_config
from vietasr_tpu_torch.models import quartznet as qn
from vietasr_tpu_torch.models.convert import (params_from_jax,
                                              state_dict_from_variables,
                                              to_numpy)
from vietasr_tpu_torch.models.convert import \
    variables_from_checkpoints as port_from_pt
from vietasr_tpu_torch.models.layers import activation_fn, group_shuffle
from vietasr_tpu_torch.models.quantize import calibrate_activations
from vietasr_tpu_torch.models.quartznet import (fold_batchnorm,
                                                init_quartznet, map_tree,
                                                quartznet_apply, tree_leaves)
from vietasr_tpu_torch.ops import repeat_block
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_IN, N_CLASSES = 16, 10

_SEP = dict(separable=True, residual=True)
# name -> (blocks, encoder options); every variant at narrow width, with
# stride and dilation mixed in
VARIANTS = {
    "grouped": ([dict(filters=32, kernel=11, stride=2, residual=False,
                      separable=True),
                 dict(filters=32, kernel=7, repeat=2, groups=4, **_SEP),
                 dict(filters=48, kernel=5, groups=2, dilation=2,
                      residual=False)], {}),
    "heads": ([dict(filters=32, kernel=9, stride=2, residual=False,
                    separable=True, heads=4),
               dict(filters=32, kernel=7, repeat=2, heads=8, dilation=2,
                    **_SEP)], {}),
    "se": ([dict(filters=32, kernel=9, stride=2, repeat=2, residual=False,
                 separable=True, se=True, se_reduction_ratio=4),
            dict(filters=32, kernel=7, repeat=2, se=True,
                 se_reduction_ratio=8, **_SEP),
            dict(filters=40, kernel=1, residual=False)], {}),
    "dense": ([dict(filters=24, kernel=11, stride=2, residual=False),
               dict(filters=32, kernel=7, repeat=2, residual_dense=True,
                    **_SEP),
               dict(filters=32, kernel=7, repeat=2, residual_dense=True,
                    **_SEP),
               dict(filters=40, kernel=9, repeat=2, residual_dense=True,
                    dilation=2, **_SEP),
               dict(filters=40, kernel=5, repeat=2, residual_dense=True,
                    **_SEP),
               dict(filters=48, kernel=1, residual=False)], {}),
    "max": ([dict(filters=32, kernel=11, stride=2, residual=False,
                  separable=True),
             dict(filters=32, kernel=7, repeat=2, **_SEP)],
            dict(residual_mode="max")),
    "hardtanh": ([dict(filters=32, kernel=11, stride=2, residual=False,
                       separable=True),
                  dict(filters=32, kernel=7, repeat=2, dilation=2, **_SEP)],
                 dict(activation="hardtanh")),
    "selu": ([dict(filters=32, kernel=11, stride=2, residual=False,
                   separable=True, groups=2),
              dict(filters=32, kernel=7, repeat=2, se=True,
                   se_reduction_ratio=4, **_SEP)],
             dict(activation="selu")),
}


def _configs(name):
    blocks, kw = VARIANTS[name]
    jcfg = JaxEncoder(blocks=tuple(JaxBlock(**b) for b in blocks),
                      feat_in=FEAT_IN, **kw)
    pcfg = EncoderConfig(blocks=tuple(BlockConfig(**b) for b in blocks),
                         feat_in=FEAT_IN, **kw)
    return jcfg, pcfg


def _variables(jcfg, seed=0):
    """JAX-initialised variables, BN statistics and affine parameters drawn
    from a seed, as numpy arrays."""
    variables = jax_init(jax.random.PRNGKey(seed), jcfg, N_CLASSES)
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if "'mean'" in name or "'bias'" in name:
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _feats(bsz=3, t=96, seed=1):
    rng = np.random.RandomState(seed)
    feats = rng.randn(bsz, t, FEAT_IN).astype(np.float32)
    lens = np.array([t, t - 13, t // 2 + 1][:bsz], np.int32)
    return feats, lens


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def _leaves_with_path(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree))


def _at(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


# ---------------------------------------------------------------------------
# layers


def test_activation_and_shuffle_match_jax():
    from vietasr_tpu.models.layers import activation_fn as jax_act
    from vietasr_tpu.models.layers import group_shuffle as jax_shuffle
    from vietasr_tpu.models.layers import squeeze_excite as jax_se
    from vietasr_tpu_torch.models.layers import squeeze_excite

    x = (np.random.RandomState(0).randn(2, 9, 12) * 12).astype(np.float32)
    for name in ("relu", "hardtanh", "selu"):
        np.testing.assert_allclose(
            activation_fn(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jax_act(name)(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    got = activation_fn("hardtanh")(torch.tensor([-3.0, 0.5, 19.0, 25.0]))
    assert got.tolist() == [0.0, 0.5, 19.0, 20.0]
    np.testing.assert_array_equal(
        group_shuffle(torch.from_numpy(x), 3).numpy(),
        np.asarray(jax_shuffle(jnp.asarray(x), 3)))
    se = {"w1": np.random.RandomState(1).randn(12, 3).astype(np.float32),
          "w2": np.random.RandomState(2).randn(3, 12).astype(np.float32)}
    np.testing.assert_allclose(
        squeeze_excite(torch.from_numpy(x),
                       map_tree(torch.from_numpy, se)).numpy(),
        np.asarray(jax_se(jnp.asarray(x), se)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        activation_fn("gelu")


# ---------------------------------------------------------------------------
# forward, training mode, fold


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("fold", [False, True])
def test_forward_fp32_matches_jax(name, fold):
    jcfg, pcfg = _configs(name)
    variables = _variables(jcfg)
    if fold:
        variables = jax.tree_util.tree_map(np.asarray,
                                           jax_fold(variables, jcfg))
    feats, lens = _feats()
    want, want_lens, _ = jax_apply(variables, jnp.asarray(feats),
                                   jnp.asarray(lens), cfg=jcfg)
    got, got_lens = quartznet_apply(
        params_from_jax(variables, device="cpu"), torch.from_numpy(feats),
        torch.from_numpy(lens), cfg=pcfg)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_bf16_per_op_matches_jax(name):
    """bf16, folded, every block per op in both packages."""
    jcfg, pcfg = _configs(name)
    folded = jax.tree_util.tree_map(np.asarray,
                                    jax_fold(_variables(jcfg, seed=2), jcfg))
    feats, lens = _feats(seed=3)
    want, want_lens, _ = jax_apply(folded, jnp.asarray(feats),
                                   jnp.asarray(lens), cfg=jcfg,
                                   compute_dtype=jnp.bfloat16)
    got, got_lens = quartznet_apply(
        params_from_jax(folded, device="cpu"), torch.from_numpy(feats),
        torch.from_numpy(lens), cfg=pcfg, compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-2


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_training_mode_matches_jax(name):
    """Batch-stat BN, dropout 0: log-probs, new stats and the gradient of
    sum(log_probs * seeded weights) w.r.t. every parameter."""
    jcfg, pcfg = _configs(name)
    variables = _variables(jcfg, seed=4)
    feats, lens = _feats(seed=5)
    weight = np.random.RandomState(6).randn(
        *np.asarray(jax_apply(variables, jnp.asarray(feats),
                              jnp.asarray(lens), cfg=jcfg)[0]).shape
    ).astype(np.float32)

    def jax_loss(params):
        lp, _, st = jax_apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jnp.asarray(feats), jnp.asarray(lens),
                              cfg=jcfg, training=True)
        return jnp.sum(lp * weight), (lp, st)

    (_, (want_lp, want_stats)), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(variables["params"])
    port = params_from_jax(variables, device="cpu")
    params = map_tree(lambda t: t.requires_grad_(True), port["params"])
    got_lp, _, got_stats = quartznet_apply(
        {"params": params, "batch_stats": port["batch_stats"]},
        torch.from_numpy(feats), torch.from_numpy(lens), cfg=pcfg,
        training=True)
    loss = torch.sum(got_lp * torch.from_numpy(weight))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert _rel(got_lp.detach(), want_lp) <= 1e-4
    stats_np = to_numpy(got_stats)
    for path, want in _leaves_with_path(want_stats):
        assert _rel(_at(stats_np, path), want) <= 1e-4, path
    grad_tree = to_numpy(map_tree(lambda g: g, _rebuild(params, grads)))
    n = 0
    for path, want in _leaves_with_path(want_grads):
        assert _rel(_at(grad_tree, path), want) <= 1e-4, path
        n += 1
    assert n == len(grads)


def _rebuild(tree, leaves):
    """`tree` with its leaves replaced, in tree_leaves order."""
    it = iter(leaves)
    return map_tree(lambda _: next(it), tree)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_fold_batchnorm_within_2ulp_of_fp64(name):
    """Each folded leaf lies within 2 ulp of the fold done in fp64, an ulp being 2^-23 relative to the
    operand of the last rounding: the folded weight w * inv itself, and
    for the bias max(|bias|, |mean * inv|), since bias - mean * inv may
    cancel (each fp32 step rounds by half that: inv's sqrt and divide,
    then the product; the product, then the difference). JAX's own fp32
    fold differs from the port's by an ulp of inv in a few channels
    (XLA's divide), so it is no exact reference."""
    jcfg, pcfg = _configs(name)
    variables = _variables(jcfg, seed=7)
    got = to_numpy(fold_batchnorm(params_from_jax(variables, device="cpu"),
                                  pcfg))
    exact, scale = _fold64(variables, jcfg)
    n = 0
    for path, want in _leaves_with_path(exact):
        g = np.asarray(_at(got, path))
        ulp = 2.0 ** -23 * np.asarray(_at(scale, path))
        assert (np.abs(g.astype(np.float64) - want) <= 2 * ulp).all(), path
        n += 1
    assert n == len(tree_leaves(got["params"]))


def _fold64(variables, jcfg):
    """(JAX's fold_batchnorm tree with each conv and bias computed in fp64,
    the same tree of each leaf's rounding scale)."""
    want = jax.tree_util.tree_map(np.asarray, jax_fold(variables, jcfg))
    scale = jax.tree_util.tree_map(np.abs, want)
    stats = variables["batch_stats"]["encoder"]

    def fold(out, sc, key, w, bn, st):
        inv = np.float64(bn["scale"]) / np.sqrt(np.float64(st["var"])
                                                 + 1e-3)
        out[key] = np.float64(w) * inv
        out["b"] = np.float64(bn["bias"]) - np.float64(st["mean"]) * inv
        sc[key] = np.abs(out[key])
        sc["b"] = np.maximum(np.abs(bn["bias"]),
                             np.abs(np.float64(st["mean"]) * inv))

    for i, bcfg in enumerate(jcfg.blocks):
        block = variables["params"]["encoder"][i]
        key = "pw_w" if bcfg.separable else "conv_w"
        for kind, k in (("sub", key), ("res", "conv_w")):
            for j, layer in enumerate(block[kind]):
                fold(want["params"]["encoder"][i][kind][j],
                     scale["params"]["encoder"][i][kind][j], k, layer[k],
                     layer["bn"], stats[i][kind][j]["bn"])
    return want, scale


def test_init_tree_matches_jax_shapes():
    for name in VARIANTS:
        jcfg, pcfg = _configs(name)
        want = jax_init(jax.random.PRNGKey(0), jcfg, N_CLASSES)
        got = to_numpy(init_quartznet(torch.Generator().manual_seed(0), pcfg,
                                      N_CLASSES))
        paths = [(p, w.shape) for p, w in _leaves_with_path(want)]
        assert len(paths) == len(tree_leaves(got))
        for path, shape in paths:
            assert _at(got, path).shape == shape, (name, path)


# ---------------------------------------------------------------------------
# block routing


_ELIGIBLE = dict(filters=32, kernel=7, **_SEP)
_FIRST = dict(filters=32, kernel=11, stride=2, residual=False,
              separable=True)
# name -> (blocks, encoder options, pw_fn or None): each holds a block that
# block_eligible accepts, and breaks one of JAX's fused conditions
ROUTE_OFF = {
    "hardtanh": ([_FIRST, _ELIGIBLE], dict(activation="hardtanh"), None),
    "selu": ([_FIRST, _ELIGIBLE], dict(activation="selu"), None),
    "max": ([_FIRST, _ELIGIBLE], dict(residual_mode="max"), None),
    "no_conv_mask": ([_FIRST, _ELIGIBLE], dict(conv_mask=False), None),
    "pw_fn": ([_FIRST, _ELIGIBLE], {},
              lambda tag, x, w: qn.pointwise_conv(x, w)),
    "residual_dense": ([_FIRST, dict(_ELIGIBLE, residual_dense=True)], {},
                       None),
    # block 2's pane 0 reads xs[0] (the dense block's input), not its own
    # input: len(xs) == 2
    "after_dense": ([_FIRST, dict(_ELIGIBLE, residual_dense=True),
                     _ELIGIBLE], {}, None),
}


def _count_plain(monkeypatch):
    calls = []
    plain = repeat_block.fused_repeat_block_plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(repeat_block, "fused_repeat_block_plain", counted)
    monkeypatch.setattr(qn, "fused_repeat_block_plain", counted)
    return calls


def _route_forward(blocks, kw, pw_fn, bf16=True):
    jcfg = JaxEncoder(blocks=tuple(JaxBlock(**b) for b in blocks),
                      feat_in=FEAT_IN, **kw)
    pcfg = EncoderConfig(blocks=tuple(BlockConfig(**b) for b in blocks),
                         feat_in=FEAT_IN, **kw)
    folded = jax_fold(_variables(jcfg), jcfg)
    feats, lens = _feats()
    extra = {"pw_fn": pw_fn} if pw_fn else {}
    return quartznet_apply(params_from_jax(folded, device="cpu"),
                           torch.from_numpy(feats), torch.from_numpy(lens),
                           cfg=pcfg, compute_dtype=torch.bfloat16
                           if bf16 else None, **extra)


@pytest.mark.parametrize("name", sorted(ROUTE_OFF))
def test_repeat_route_off_where_jax_would_not_fuse(name, monkeypatch):
    calls = _count_plain(monkeypatch)
    blocks, kw, pw_fn = ROUTE_OFF[name]
    _route_forward(blocks, kw, pw_fn)
    assert len(calls) == 0
    # the same blocks under JAX's fused conditions do take the route
    _route_forward([_FIRST, _ELIGIBLE], {}, None)
    assert len(calls) == 1
    _route_forward([_FIRST, _ELIGIBLE], {}, None, bf16=False)
    assert len(calls) == 1


def test_repeat_route_still_taken_on_12x1(monkeypatch):
    """The 13 eligible blocks of QuartzNet12x1 each take it once."""
    calls = _count_plain(monkeypatch)
    tr = Transcriber(os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                                  "quartznet12x1_vi.yaml"),
                     checkpoint=os.path.join(
                         ROOT, "artifacts",
                         "real_speech_qn12x1_vi.msgpack.gz"),
                     device="cpu",
                     options=TranscriberOptions(buckets_seconds=(1.0,)))
    tr.log_probs((np.random.RandomState(0).randn(16000) * 0.1)
                 .astype(np.float32))
    assert len(calls) == 13


def test_dense_residual_list_carries_every_dense_input():
    """After k dense-residual blocks xs holds their k inputs and the last
    output; the block after a dense run reads pane 0 from xs[0]."""
    _, pcfg = _configs("dense")
    variables = init_quartznet(torch.Generator().manual_seed(0), pcfg,
                               N_CLASSES)
    panes = [len(b["res"]) for b in variables["params"]["encoder"]]
    assert panes == [0, 1, 2, 3, 4, 0]
    feats, lens = (torch.from_numpy(a) for a in _feats())
    xs = [feats]
    for i, bcfg in enumerate(pcfg.blocks):
        xs, lens, _ = qn._apply_block(
            xs, lens, variables["params"]["encoder"][i],
            variables["batch_stats"]["encoder"][i], bcfg, pcfg, None,
            "auto")
        assert len(xs) == [1, 2, 3, 4, 5, 1][i]


# ---------------------------------------------------------------------------
# NeMo checkpoints, Transcribers, int8 calibration


JASPER_BLOCKS = [
    dict(filters=32, repeat=1, kernel=[11], stride=[2], dilation=[1],
         dropout=0.0, residual=False),
    dict(filters=32, repeat=2, kernel=[11], stride=[1], dilation=[1],
         dropout=0.2, residual=True, residual_dense=True),
    dict(filters=48, repeat=2, kernel=[13], stride=[1], dilation=[1],
         dropout=0.2, residual=True, residual_dense=True),
    dict(filters=48, repeat=2, kernel=[9], stride=[1], dilation=[1],
         dropout=0.2, residual=True, residual_dense=True, groups=2,
         separable=True),
    dict(filters=64, repeat=1, kernel=[7], stride=[1], dilation=[2],
         dropout=0.4, residual=False),
    dict(filters=80, repeat=1, kernel=[1], stride=[1], dilation=[1],
         dropout=0.4, residual=False),
]
LABELS = [" ", "a", "b", "c", "d", "e", "g", "h", "i", "k"]


def _jasper_yaml(tmp_path):
    path = tmp_path / "jasper_narrow.yaml"
    path.write_text(yaml.safe_dump({
        "model": "jasper_narrow",
        "AudioToMelSpectrogramPreprocessor": {
            "sample_rate": 16000, "window_size": 0.02,
            "window_stride": 0.01, "window": "hann",
            "normalize": "per_feature", "n_fft": 512, "features": 64,
            "dither": 0.0, "pad_to": 16},
        "JasperEncoder": {"activation": "relu", "conv_mask": True,
                          "jasper": JASPER_BLOCKS},
        "labels": LABELS}, allow_unicode=True))
    return str(path)


def test_jasper_nemo_checkpoint_through_both_converters(tmp_path):
    """A narrow dense-residual Jasper (with a grouped block) as the
    reference's two .pt files: both converters give the same tree, and
    both Transcribers the same log-probs and texts."""
    cfg_path = _jasper_yaml(tmp_path)
    pcfg = load_config(cfg_path)
    from vietasr_tpu.config import load_config as jax_load_config
    from vietasr_tpu.models.convert import \
        variables_from_checkpoints as jax_from_pt

    jcfg = jax_load_config(cfg_path)
    variables = _variables(jcfg.encoder, seed=8)
    sd = state_dict_from_variables(variables, pcfg.encoder)
    enc_pt, dec_pt = str(tmp_path / "enc.pt"), str(tmp_path / "dec.pt")
    for path, prefix in ((enc_pt, "encoder."), (dec_pt, "decoder_layers.")):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items() if k.startswith(prefix)}, path)
    got = port_from_pt(enc_pt, dec_pt, pcfg.encoder)
    want = jax_from_pt(enc_pt, dec_pt, jcfg.encoder)
    for path, w in _leaves_with_path(want):
        np.testing.assert_array_equal(np.asarray(_at(got, path)), w)
    signals = [(np.random.RandomState(s).randn(n) * 0.1).astype(np.float32)
               for s, n in ((0, 24000), (1, 15000), (2, 31000))]
    port = Transcriber(cfg_path, encoder_checkpoint=enc_pt,
                       decoder_checkpoint=dec_pt, device="cpu",
                       options=TranscriberOptions(compute_dtype=None))
    ref = JaxTranscriber(cfg_path, encoder_checkpoint=enc_pt,
                         decoder_checkpoint=dec_pt,
                         options=JaxOptions(compute_dtype=None))
    for sig in signals:
        lp = port.log_probs(sig)[0]
        want_lp = np.asarray(ref.log_probs(sig)[0])
        assert np.abs(np.asarray(lp) - want_lp).max() <= 1e-4
    assert port.transcribe_batch(signals) == ref.transcribe_batch(signals)


def test_calibrate_int8_sites_match_jax_on_dense_residual():
    """enc{i}.res{p} for every pane p of a dense-residual block; grouped
    sub-layers are no pw_fn site."""
    jcfg = JaxEncoder(blocks=tuple(JaxBlock(**b) for b in
                                   VARIANTS["dense"][0]
                                   + [dict(filters=32, kernel=5, groups=2,
                                           separable=True, residual=False)]),
                      feat_in=FEAT_IN)
    pcfg = EncoderConfig(blocks=tuple(BlockConfig(**b) for b in
                                      VARIANTS["dense"][0]
                                      + [dict(filters=32, kernel=5, groups=2,
                                              separable=True,
                                              residual=False)]),
                         feat_in=FEAT_IN)
    folded = jax.tree_util.tree_map(np.asarray,
                                    jax_fold(_variables(jcfg), jcfg))
    feats, lens = _feats()
    want = jax_calibrate(folded, jcfg, jnp.asarray(feats), jnp.asarray(lens),
                         compute_dtype=jnp.bfloat16)
    got = calibrate_activations(params_from_jax(folded, device="cpu"), pcfg,
                                torch.from_numpy(feats),
                                torch.from_numpy(lens))
    assert set(got) == set(want)
    assert {"enc4.res3", "enc2.res1", "dec"} <= set(got)
    assert not any(t.startswith("enc6.sub") for t in got)
    for tag in want:
        np.testing.assert_allclose(got[tag], float(want[tag]), rtol=1e-2)
