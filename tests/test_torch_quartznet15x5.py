"""QuartzNet15x5 in vietasr_tpu_torch vs the JAX package's, on the CPU.

The repo ships no 15x5 config: `chip_smoke.write_qn15x5_yaml` writes one
at run time (quartznet12x1_vi.yaml's sections with the encoder of Kriman
et al. 2019, "QuartzNet", Table 1), and these tests use it as a fixture.
Its 15 R = 5 blocks are the shape the Pallas repeat kernel was written for;
on the GPU each is one launch of the whole-block kernel, here its plain
version. Tolerances: fp32 log-probs within 1e-4 (fp32 sums in another
order, as tests/test_torch_pipeline.py); the bf16 kernel route against
JAX's Pallas route (interpret mode) within 1e-2, as
tests/test_torch_quartznet.py holds 12x1's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vietasr_tpu.config import BlockConfig as JaxBlock
from vietasr_tpu.config import EncoderConfig as JaxEncoder
from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.models.quartznet import fold_batchnorm as jax_fold
from vietasr_tpu.models.quartznet import init_quartznet as jax_init
from vietasr_tpu.models.quartznet import quartznet_apply as jax_apply
from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch import _build
from vietasr_tpu_torch.config import BlockConfig, EncoderConfig, load_config
from vietasr_tpu_torch.models import quartznet as qn
from vietasr_tpu_torch.models.convert import params_from_jax
from vietasr_tpu_torch.models.quartznet import (fold_batchnorm,
                                                init_quartznet,
                                                quartznet_apply, tree_leaves,
                                                tree_paths)
from vietasr_tpu_torch.ops.repeat_block import (block_eligible,
                                                whole_block_plan)
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(1)

# Table 1 of the QuartzNet paper: (filters, kernel, repeat, stride,
# dilation, residual, separable) of C1, B1-B5 (3 blocks each), C2, C3
PAPER_TABLE = ([(256, 33, 1, 2, 1, False, True)]
               + [(c, k, 5, 1, 1, True, True)
                  for c, k in ((256, 33), (256, 39), (512, 51), (512, 63),
                               (512, 75)) for _ in range(3)]
               + [(512, 87, 1, 1, 2, False, True),
                  (1024, 1, 1, 1, 1, False, False)])


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    return chip_smoke.write_qn15x5_yaml(str(tmp_path_factory.mktemp("qn")))


def _perturb_bn(variables, seed):
    """BN statistics and affine parameters drawn from a seed (JAX's init
    leaves them at 0 / 1, which makes a 15x5's log-probs near uniform:
    0.06 nats from top to bottom), numpy leaves."""
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


@pytest.fixture(scope="module")
def jax_variables(config):
    """JAX's init_quartznet on the fixture (seed 0), BN drawn from seed 0
    (0.82 nats from top to bottom of a frame's log-probs)."""
    cfg = jax_load_config(config)
    return _perturb_bn(jax_init(jax.random.PRNGKey(0), cfg.encoder,
                                cfg.num_classes), seed=0)


def test_block_list_is_the_paper_table(config):
    cfg = load_config(config)
    got = [(b.filters, b.kernel, b.repeat, b.stride, b.dilation, b.residual,
            b.separable) for b in cfg.encoder.blocks]
    assert got == PAPER_TABLE
    assert cfg.name == "quartznet15x5_vi" and cfg.num_classes == 90
    # the JAX loader reads the same file into the same blocks
    jcfg = jax_load_config(config)
    assert [(b.filters, b.kernel, b.repeat, b.stride, b.dilation, b.residual,
             b.separable) for b in jcfg.encoder.blocks] == PAPER_TABLE
    # and the rest is quartznet12x1_vi.yaml's
    vi = load_config(chip_smoke.CONFIG)
    assert cfg.featurizer == vi.featurizer and cfg.labels == vi.labels


def test_init_param_count_equals_jax(config, jax_variables):
    """The port's init_quartznet draws a tree of the same shapes as JAX's:
    leaf for leaf, and so the same parameter count."""
    cfg = load_config(config)
    port = init_quartznet(torch.Generator().manual_seed(0), cfg.encoder,
                          cfg.num_classes)

    def shapes(tree):
        return dict(zip(tree_paths(tree),
                        (tuple(a.shape) for a in tree_leaves(tree))))

    want = jax_variables["params"]
    assert shapes(port["params"]) == shapes(want)
    n_port = sum(a.numel() for a in tree_leaves(port["params"]))
    n_jax = sum(a.size for a in tree_leaves(want))
    assert n_port == n_jax
    assert 18_000_000 < n_port < 20_000_000   # the paper's ~18.9 M + head


def test_every_whole_block_of_the_fixture_has_a_plan(config):
    """Each eligible R = 5 block fits the whole-block kernel's shared memory
    per block of its cluster, at the 16.7 s bucket (B = 8, T = 840) and the
    2 s bucket (B = 1, T = 100); the blocks that are not eligible are C1
    (stride 2), C2 (dilation 2) and C3 (not separable)."""
    cfg = load_config(config)
    folded = fold_batchnorm(init_quartznet(torch.Generator().manual_seed(0),
                                           cfg.encoder, cfg.num_classes),
                            cfg.encoder)
    params = folded["params"]["encoder"]
    eligible = [i for i, b in enumerate(cfg.encoder.blocks)
                if block_eligible(b, params[i], False)]
    assert eligible == list(range(1, 16))
    c_in = cfg.encoder.blocks[0].filters
    for i in eligible:
        b = cfg.encoder.blocks[i]
        for bsz, t in ((8, 840), (1, 100)):
            plan = whole_block_plan(bsz, t, c_in, b.filters, b.kernel,
                                    b.repeat)
            assert plan.smem_bytes <= _build.SMEM_LIMIT
            assert plan.cluster * plan.cols == b.filters <= 512
        c_in = b.filters
    with pytest.raises(ValueError, match="C_out=1024"):
        whole_block_plan(8, 840, 512, 1024, 75, 5)


# a narrow 15x5: C1, three R = 5 blocks at 15x5's kernels (widening at the
# second), C2 dilated, C3 dense
NARROW = [dict(filters=32, kernel=11, stride=2, residual=False,
               separable=True),
          dict(filters=32, repeat=5, kernel=33, residual=True,
               separable=True),
          dict(filters=48, repeat=5, kernel=51, residual=True,
               separable=True),
          dict(filters=48, repeat=5, kernel=75, residual=True,
               separable=True),
          dict(filters=48, kernel=17, dilation=2, residual=False,
               separable=True),
          dict(filters=64, kernel=1, residual=False, separable=False)]
FEAT_IN, N_CLASSES = 16, 10


def _narrow(seed):
    """JAX-initialised, BN statistics drawn from a seed, folded; and the
    port's config of the same blocks."""
    ecfg = JaxEncoder(blocks=tuple(JaxBlock(**b) for b in NARROW),
                      feat_in=FEAT_IN)
    variables = _perturb_bn(jax_init(jax.random.PRNGKey(seed), ecfg,
                                     N_CLASSES), seed)
    folded = jax.tree_util.tree_map(np.asarray, jax_fold(variables, ecfg))
    port_cfg = EncoderConfig(blocks=tuple(BlockConfig(**b) for b in NARROW),
                             feat_in=FEAT_IN)
    return folded, ecfg, port_cfg


def _feats(seed, bsz=3, t=120):
    rng = np.random.RandomState(seed)
    feats = rng.randn(bsz, t, FEAT_IN).astype(np.float32)
    lens = np.array([t, t - 37, 1][:bsz], np.int32)
    return feats, lens


def test_narrow_15x5_kernel_route_matches_jax_pallas_route(monkeypatch):
    """bf16, folded: the port's kernel route (the whole-block kernel's plain
    version on the CPU, 3 R = 5 blocks) vs JAX's block_impl="pallas"
    (interpret mode), lengths equal and max |d log p| <= 1e-2 (measured
    4.8e-7: one activation's bf16 rounding may fall the other way)."""
    folded, ecfg, port_cfg = _narrow(seed=7)
    feats, lens = _feats(seed=8)
    want, want_lens, _ = jax_apply(folded, jnp.asarray(feats),
                                   jnp.asarray(lens), cfg=ecfg,
                                   compute_dtype=jnp.bfloat16,
                                   block_impl="pallas")
    calls = []
    real = qn.fused_repeat_block

    def record(*args, **kw):
        calls.append(len(args[2]))
        return real(*args, **kw)

    monkeypatch.setattr(qn, "fused_repeat_block", record)
    got, got_lens = quartznet_apply(
        params_from_jax(folded, device="cpu"), torch.from_numpy(feats),
        torch.from_numpy(lens), cfg=port_cfg, compute_dtype=torch.bfloat16,
        block_impl="kernel")
    assert calls == [5, 5, 5]
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-2


def test_narrow_15x5_matches_jax_xla_path():
    """Against JAX's default (XLA, per-op) path: in fp32 the port's per-op
    blocks within 1e-4 (measured 4.8e-7); in bf16 its kernel route, which
    keeps each R = 5 block's intermediates in fp32 where the per-op path
    rounds every repeat's output to bf16, within 1e-2 of max |d log p|
    (measured 6.9e-4) and argmax agreement >= 0.95 (measured 1.0)."""
    folded, ecfg, port_cfg = _narrow(seed=9)
    feats, lens = _feats(seed=10)
    port_vars = params_from_jax(folded, device="cpu")
    for jdt, tdt, tol in ((None, None, 1e-4),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want, want_lens, _ = jax_apply(folded, jnp.asarray(feats),
                                       jnp.asarray(lens), cfg=ecfg,
                                       compute_dtype=jdt)
        got, got_lens = quartznet_apply(
            port_vars, torch.from_numpy(feats), torch.from_numpy(lens),
            cfg=port_cfg, compute_dtype=tdt)
        want = np.asarray(want)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        valid = np.arange(want.shape[1])[None, :] < np.asarray(want_lens)[:,
                                                                          None]
        d = np.abs(got.numpy() - want)[valid]
        assert d.max() <= tol, (jdt, d.max())
        agree = (got.numpy().argmax(-1) == want.argmax(-1))[valid].mean()
        assert agree >= 0.95


# R = 5 blocks whose widths the whole-block kernel cannot split: 16 -> 512
# (2 input channels a block of 8) and 512 -> 1024 (16 blocks of 64 columns)
WIDE = [dict(filters=16, kernel=11, stride=2, residual=False,
             separable=True),
        dict(filters=512, repeat=5, kernel=9, residual=True, separable=True),
        dict(filters=1024, repeat=5, kernel=33, residual=True,
             separable=True),
        dict(filters=32, kernel=1, residual=False, separable=False)]


def test_wide_r5_blocks_take_the_per_op_path(monkeypatch):
    """An R = 5 block the whole-block plan cannot take is not sent to the
    fused repeat block under the default route (on the GPU it would raise
    there): it runs per op, as JAX's default path runs it, and the bf16
    forward stays within 1e-2 of max |d log p| of JAX's (both per op;
    measured 4.8e-7)."""
    ecfg = JaxEncoder(blocks=tuple(JaxBlock(**b) for b in WIDE),
                      feat_in=FEAT_IN)
    folded = jax.tree_util.tree_map(np.asarray, jax_fold(_perturb_bn(
        jax_init(jax.random.PRNGKey(3), ecfg, N_CLASSES), 3), ecfg))
    port_cfg = EncoderConfig(blocks=tuple(BlockConfig(**b) for b in WIDE),
                             feat_in=FEAT_IN)
    feats, lens = _feats(seed=4, bsz=2, t=40)
    port_vars = params_from_jax(folded, device="cpu")
    blocks = port_vars["params"]["encoder"]
    assert [block_eligible(b, blocks[i], False)
            for i, b in enumerate(port_cfg.blocks)] == [False, True, True,
                                                        False]
    for i in (1, 2):
        assert not qn.kernel_route([torch.zeros(1)], blocks[i],
                                   port_cfg.blocks[i], port_cfg,
                                   torch.bfloat16, False, qn._default_pw)
    calls = []
    monkeypatch.setattr(qn, "fused_repeat_block",
                        lambda *a, **kw: calls.append(a))
    got, got_lens = quartznet_apply(port_vars, torch.from_numpy(feats),
                                    torch.from_numpy(lens), cfg=port_cfg,
                                    compute_dtype=torch.bfloat16)
    assert calls == []
    want, want_lens, _ = jax_apply(folded, jnp.asarray(feats),
                                   jnp.asarray(lens), cfg=ecfg,
                                   compute_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-2


@pytest.fixture(scope="module")
def clip():
    rng = np.random.RandomState(15)
    return (rng.randn(32000) * 0.1).astype(np.float32)     # 2 s


def test_full_width_transcriber_matches_jax(config, jax_variables, clip):
    """The full-width 15x5 Transcriber on the CPU in fp32 vs JAX's on the
    same weights (JAX's init, carried by params_from_jax): log-probs within
    1e-4, lengths and greedy text equal."""
    jax_tr = JaxTranscriber(config, variables=jax_variables,
                            options=JaxOptions(compute_dtype=None))
    port = Transcriber(config, variables=jax_variables, device="cpu",
                       options=TranscriberOptions(compute_dtype=None))
    want, want_lens = jax_tr.log_probs(clip)
    got, got_lens = port.log_probs(clip)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_lens, want_lens)
    assert np.abs(got - want).max() <= 1e-4
    assert port.transcribe(clip) == jax_tr.transcribe(clip)


def test_full_width_bf16_transcriber_routes_every_r5_block(config,
                                                           jax_variables,
                                                           clip,
                                                           monkeypatch):
    """The default bf16 options send B1-B5's 15 blocks, and only those,
    through the fused repeat block, one call a block (on the GPU: one
    whole-block launch each); the result stays near the fp32 forward
    (measured max |d log p| 1.1e-3, argmax equal; bound 0.05 for bf16
    roundings over 18 blocks)."""
    calls = []
    real = qn.fused_repeat_block

    def record(*args, **kw):
        calls.append((tuple(args[0].shape), len(args[2]), kw["kernel"]))
        return real(*args, **kw)

    monkeypatch.setattr(qn, "fused_repeat_block", record)
    bf16 = Transcriber(config, variables=jax_variables, device="cpu")
    fp32 = Transcriber(config, variables=jax_variables, device="cpu",
                       options=TranscriberOptions(compute_dtype=None))
    lp, lens = bf16.log_probs(clip)
    # block i's input channels are block i - 1's filters
    assert [c for (_, _, c), _, _ in calls] == \
        [PAPER_TABLE[i - 1][0] for i in range(1, 16)]
    assert [r for _, r, _ in calls] == [5] * 15
    assert [k for _, _, k in calls] == [b[1] for b in PAPER_TABLE[1:16]]
    calls.clear()
    lp32, lens32 = fp32.log_probs(clip)
    assert calls == []                 # fp32 runs every block per op
    np.testing.assert_array_equal(lens, lens32)
    assert np.abs(lp - lp32).max() <= 0.05
    assert (lp.argmax(-1) == lp32.argmax(-1)).mean() >= 0.95
