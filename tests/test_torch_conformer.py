"""vietasr_tpu_torch's Conformer-CTC (models/conformer.py, the model
dispatch and the Conformer Transcriber) against the JAX package's, on the
CPU:

- `ConformerConfig` parsing and parameter counts equal JAX's for the five
  shipped YAMLs (27,346,779 for conformer_ctc_vi, 25,525,339 for its
  stack-subsampled and streaming twins);
- `init_conformer`'s tree, shapes and constants equal `model_init`'s;
- `rel_pos_encoding_range` equal, `_rel_shift` equal, and the matmul-form
  position term equal to the shifted product it replaces;
- `conformer_apply` on JAX's own weights (`params_from_jax`), fp32,
  within 1e-4 in log p over conv2d and stack subsampling, full context and
  chunked (chunk 4, left 1 and 2), conv kernels 5 and 7, ragged lengths:
  equal `out_lens`, valid frames only; in bf16 against JAX's op-by-op
  (eager) bf16 within 1e-5 (the rounding points are JAX's), and against
  its jitted bf16, where XLA's fusion keeps excess precision between bf16
  ops, frame argmax >= 0.98 and |d log p| <= 0.25;
- one full-width conformer_ctc_vi fp32 forward at B = 2 x 2 s against JAX
  within 1e-3 (16 blocks of fp32 sums in another order);
- `Transcriber(device="cpu")` on a narrow Conformer YAML: texts equal to
  JAX's Transcriber, greedy and device_beam with a word 3-gram, in fp32;
  in bf16 (JAX's Transcriber jits) frame argmax >= 0.98 over 5 signals
  and |d log p| <= 0.25;
- the refusals: calibrate_int8, training, remat, NeMo .pt weights and
  the .pt converters, make_loss_fn on a Conformer config; every
  long-form entry point, which takes a Conformer, and its frame count.
"""

import dataclasses
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vietasr_tpu.models.conformer as J
from vietasr_tpu.config import ConformerConfig as JaxConformerConfig
from vietasr_tpu.config import DataConfig
from vietasr_tpu.config import EncoderConfig as JaxEncoderConfig
from vietasr_tpu.config import ModelConfig as JaxModelConfig
from vietasr_tpu.config import SpecAugmentConfig as JaxSpecAugmentConfig
from vietasr_tpu.config import load_config as jax_load_config
from vietasr_tpu.frontend.features import FeaturizerConfig as JaxFeatCfg
from vietasr_tpu.models import model_init as jax_model_init
from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch import models as P_models
from vietasr_tpu_torch.config import (ConformerConfig, EncoderConfig,
                                      ModelConfig, SpecAugmentConfig,
                                      load_config)
from vietasr_tpu_torch.frontend.features import FeaturizerConfig
from vietasr_tpu_torch.models import conformer as P
from vietasr_tpu_torch.models.convert import (load_anchor, params_from_jax,
                                              to_numpy)
from vietasr_tpu_torch.ops.lm import train_ngram_arpa
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ["conformer_ctc_vi.yaml", "conformer_ctc_vi_s.yaml",
         "conformer_ctc_vi_s_streaming.yaml", "conformer_ctc_vi_stack.yaml",
         "conformer_ctc_vi_streaming.yaml"]
FP32_TOL = 1e-4
BF16_EAGER_TOL = 1e-5
BF16_JIT_TOL = 0.25
ARGMAX_MIN = 0.98
LABELS = [" ", "a", "b", "c"]
CORPUS = ["ab cab ba", "ab ba", "cab ab ba c", "ba cab", "c ab"] * 2


def port_yaml(name):
    return os.path.join(ROOT, "vietasr_tpu_torch", "configs", name)


def conformer_kw(**over):
    kw = dict(num_blocks=2, d_model=32, num_heads=4, ff_expansion=2,
              conv_kernel=7, subsampling_channels=16, dropout=0.0)
    kw.update(over)
    return kw


def make_cfgs(features=16, labels=LABELS, feat_over=None, **over):
    """(JAX ModelConfig, port ModelConfig) of one narrow Conformer."""
    kw = conformer_kw(**over)
    fk = dict(features=features, dither=0.0, pad_to=8)
    fk.update(feat_over or {})
    jax_cfg = JaxModelConfig(
        name="tiny", labels=list(labels), featurizer=JaxFeatCfg(**fk),
        encoder=JaxEncoderConfig(blocks=(), feat_in=features),
        spec_augment=JaxSpecAugmentConfig(), data=DataConfig(),
        architecture="conformer", conformer=JaxConformerConfig(**kw))
    cfg = ModelConfig(
        name="tiny", labels=list(labels), featurizer=FeaturizerConfig(**fk),
        encoder=EncoderConfig(blocks=(), feat_in=features),
        spec_augment=SpecAugmentConfig(), architecture="conformer",
        conformer=ConformerConfig(**kw))
    return jax_cfg, cfg


def jax_variables(jax_cfg, seed=0, perturb=True):
    """JAX model_init's tree as numpy; with perturb, every leaf moved off
    its init constant (u / vb and the BN stats start at 0 and 1), seeded."""
    v = jax.tree_util.tree_map(np.asarray,
                               jax_model_init(jax.random.PRNGKey(seed),
                                              jax_cfg))
    if not perturb:
        return v
    rng = np.random.RandomState(seed)
    v = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32), v)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


def valid_max_err(a, b, lens):
    return max(float(np.abs(a[i, :n] - b[i, :n]).max())
               for i, n in enumerate(lens) if n)


def valid_argmax(a, b, lens):
    return float(np.mean(np.concatenate(
        [a[i, :n].argmax(-1) == b[i, :n].argmax(-1)
         for i, n in enumerate(lens)])))


def run_both(jax_cfg, cfg, variables, feats, lens, jax_dtype=None,
             dtype=None, jit=False):
    fn = lambda f, ln: J.conformer_apply(                   # noqa: E731
        variables, f, ln, cfg=jax_cfg.conformer, compute_dtype=jax_dtype)
    if jit or jax_dtype is None:
        fn = jax.jit(fn)
    want, want_lens, _ = fn(jnp.asarray(feats), jnp.asarray(lens))
    tv = P.cast_matmul_weights(params_from_jax(variables, device="cpu"),
                               dtype)
    got, got_lens = P.conformer_apply(tv, torch.from_numpy(feats),
                                      torch.from_numpy(lens),
                                      cfg=cfg.conformer, compute_dtype=dtype)
    return (got.numpy(), got_lens.numpy(), np.asarray(want),
            np.asarray(want_lens))


# -- config, init, parameters ---------------------------------------------


@pytest.mark.parametrize("name", YAMLS)
def test_config_and_param_count_match_jax(name):
    jax_cfg = jax_load_config(os.path.join(ROOT, "configs", name))
    cfg = load_config(port_yaml(name))
    assert cfg.architecture == jax_cfg.architecture == "conformer"
    assert dataclasses.asdict(cfg.conformer) == \
        dataclasses.asdict(jax_cfg.conformer)
    assert cfg.labels == jax_cfg.labels
    assert cfg.featurizer.features == jax_cfg.featurizer.features
    got = P_models.model_init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    want = jax.eval_shape(lambda: jax_model_init(jax.random.PRNGKey(0),
                                                 jax_cfg))
    n_want = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(want["params"]))
    assert P.num_params(got) == n_want
    expect = {"conformer_ctc_vi.yaml": 27_346_779,
              "conformer_ctc_vi_stack.yaml": 25_525_339,
              "conformer_ctc_vi_streaming.yaml": 25_525_339}
    if name in expect:
        assert n_want == expect[name]


def _tree_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tree_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("mode", ["conv2d", "stack"])
def test_init_conformer_tree_matches_jax(mode):
    jax_cfg, cfg = make_cfgs(subsampling_mode=mode)
    want = jax_variables(jax_cfg, perturb=False)
    got = to_numpy(P.init_conformer(torch.Generator().manual_seed(0),
                                    cfg.conformer, 16, len(LABELS),
                                    device="cpu"))
    assert _tree_shapes(got) == _tree_shapes(want)
    for bp, jbp in zip(got["params"]["blocks"], want["params"]["blocks"]):
        for key in ("u", "vb"):                    # zero-initialized biases
            np.testing.assert_array_equal(bp["mhsa"][key], jbp["mhsa"][key])
        np.testing.assert_array_equal(bp["conv"]["bn"]["scale"], 1.0)
        # xavier bounds, and the linear bias bound fan_in ** -0.5
        d = cfg.conformer.d_model
        assert np.abs(bp["mhsa"]["pos"]["w"]).max() <= np.sqrt(6 / (2 * d))
        assert np.abs(bp["ff1"]["in"]["b"]).max() <= d ** -0.5
    for st, jst in zip(got["batch_stats"]["blocks"],
                       want["batch_stats"]["blocks"]):
        for key in ("mean", "var"):
            np.testing.assert_array_equal(st["conv_bn"][key],
                                          jst["conv_bn"][key])


# -- the relative position term -------------------------------------------


def test_rel_pos_encoding_and_shift_match_jax():
    for args in ((7, -7, 32), (19, -3, 16), (0, -5, 8)):
        np.testing.assert_array_equal(P.rel_pos_encoding_range(*args),
                                      J.rel_pos_encoding_range(*args))
    x = np.random.RandomState(0).randn(2, 3, 9, 17).astype(np.float32)
    np.testing.assert_array_equal(P._rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(J._rel_shift(jnp.asarray(x))))


@pytest.mark.parametrize("t,d,h", [(13, 32, 4), (50, 64, 2)])
def test_matmul_position_term_equals_shifted_product(t, d, h):
    """The matmul form sum_m (ws si + wc ci) cos(j w_m) + (wc si - ws ci)
    sin(j w_m) == the Transformer-XL term: qv . (W_pos^T e_{i-j}) with the
    shifted (T, 2T - 1) product, in fp64 (fp32 within 1e-4 relative)."""
    dh = d // h
    rng = np.random.RandomState(t)
    qv = rng.randn(2, h, t, dh)
    wp = rng.randn(d, d) / np.sqrt(d)
    # oracle: raw[i, o] = qv[i] . (e_o @ W_pos), o over [T-1 ... -(T-1)]
    pe = P.rel_pos_encoding_range(t - 1, -(t - 1), d).astype(np.float64)
    pos = (pe @ wp).reshape(2 * t - 1, h, dh)
    raw = np.einsum("bhie,ohe->bhio", qv, pos)
    want = P._rel_shift(torch.from_numpy(raw)).numpy()
    si, ci = (a.double() for a in P.position_tables(t, d, "cpu"))
    qv_t = torch.from_numpy(qv)
    w = torch.from_numpy(wp)
    w_sin = w[0::2].reshape(d // 2, h, dh).permute(1, 2, 0)
    w_cos = w[1::2].reshape(d // 2, h, dh).permute(1, 2, 0)
    ws, wc = qv_t @ w_sin, qv_t @ w_cos
    got = ((ws * si + wc * ci) @ ci.t() + (wc * si - ws * ci) @ si.t())
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale


def test_position_tables_vs_xla_sin():
    """The port's tables are the fp32 angles' sin / cos taken in float64
    and rounded once; XLA's fp32 sin / cos of the same angles (JAX's
    tables) lie within 2 ulp of them at the full-width 16.7 s bucket
    (T' = 418, D = 256; angles up to ~417 rad)."""
    t, d = 418, 256
    inv = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * (-np.log(10000.0) / d))
    ang = jnp.asarray(np.arange(t)[:, None] * inv[None, :], jnp.float32)
    si, ci = P.position_tables(t, d, "cpu")
    for got, want in ((si, jnp.sin(ang)), (ci, jnp.cos(ang))):
        want = np.asarray(want)
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got.numpy() - want) <= 2 * np.maximum(ulp, 2 ** -24)
                ).all()


# -- the forward against JAX -----------------------------------------------


FORWARD_CASES = [(mode, chunk, left, k)
                 for mode in ("conv2d", "stack")
                 for chunk, left in ((0, 1), (4, 1), (4, 2))
                 for k in (5, 7)]


@pytest.mark.parametrize("mode,chunk,left,k", FORWARD_CASES)
def test_conformer_apply_fp32_matches_jax(mode, chunk, left, k):
    jax_cfg, cfg = make_cfgs(subsampling_mode=mode, chunk_size=chunk,
                             left_chunks=left, conv_kernel=k)
    variables = jax_variables(jax_cfg, seed=k + chunk)
    rng = np.random.RandomState(k)
    feats = rng.randn(3, 75, 16).astype(np.float32)
    lens = np.array([75, 50, 13], np.int32)
    got, got_lens, want, want_lens = run_both(jax_cfg, cfg, variables,
                                              feats, lens)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got_lens, want_lens)
    assert valid_max_err(got, want, got_lens) <= FP32_TOL


@pytest.mark.parametrize("mode,chunk", [("conv2d", 0), ("stack", 0),
                                        ("conv2d", 4), ("stack", 4)])
def test_conformer_apply_bf16_matches_jax(mode, chunk):
    """bf16 at JAX's rounding points: equal to JAX's op-by-op bf16 to
    BF16_EAGER_TOL; JAX's jitted bf16 (fusion keeps excess precision
    between bf16 ops) in the bf16 class."""
    jax_cfg, cfg = make_cfgs(subsampling_mode=mode, chunk_size=chunk)
    variables = jax_variables(jax_cfg, seed=11)
    feats = np.random.RandomState(11).randn(3, 75, 16).astype(np.float32)
    lens = np.array([75, 61, 20], np.int32)
    for jit, tol in ((False, BF16_EAGER_TOL), (True, BF16_JIT_TOL)):
        got, lens_out, want, _ = run_both(jax_cfg, cfg, variables, feats,
                                          lens, jnp.bfloat16,
                                          torch.bfloat16, jit=jit)
        assert valid_max_err(got, want, lens_out) <= tol, jit
        assert valid_argmax(got, want, lens_out) >= ARGMAX_MIN, jit


def test_scan_blocks_runs_the_same_loop():
    jax_cfg, cfg = make_cfgs()
    v = params_from_jax(jax_variables(jax_cfg, seed=5), device="cpu")
    feats = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(5))
    lens = torch.tensor([40, 23])
    a, _ = P.conformer_apply(v, feats, lens, cfg=cfg.conformer)
    b, _ = P.conformer_apply(
        v, feats, lens,
        cfg=dataclasses.replace(cfg.conformer, scan_blocks=True))
    assert torch.equal(a, b)


def test_full_width_fp32_matches_jax():
    """conformer_ctc_vi at full width (16 blocks, d 256, conv2d 256
    channels), JAX's model_init weights, B = 2 x 2 s of 80-mel features,
    fp32: within 1e-3 in log p (16 blocks of fp32 sums in another
    order)."""
    name = "conformer_ctc_vi.yaml"
    jax_cfg = jax_load_config(os.path.join(ROOT, "configs", name))
    cfg = load_config(port_yaml(name))
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model_init(jax.random.PRNGKey(0), jax_cfg))
    feats = np.random.RandomState(3).randn(2, 200, 80).astype(np.float32)
    lens = np.array([200, 131], np.int32)
    got, got_lens, want, want_lens = run_both(jax_cfg, cfg, variables,
                                              feats, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape == (2, 50, len(cfg.labels) + 1)
    assert valid_max_err(got, want, got_lens) <= 1e-3


# -- the Transcriber --------------------------------------------------------


def write_narrow_yaml(path, **conformer_over):
    """conformer_ctc_vi.yaml's featurizer and labels with a narrow
    encoder."""
    with open(port_yaml("conformer_ctc_vi.yaml"), encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    raw["ConformerEncoder"].update(conformer_kw(**conformer_over))
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(raw, f, allow_unicode=True)
    return str(path)


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("conformer")
    yml = write_narrow_yaml(tmp / "narrow.yaml", d_model=48, num_heads=2,
                            subsampling_channels=16, num_blocks=2)
    cfg = jax_load_config(yml)
    variables = jax_variables(cfg, seed=7)
    arpa = str(tmp / "w3.arpa")
    train_ngram_arpa(["xin chào các bạn", "chào mừng quý vị",
                      "tin tức trong ngày", "cảm ơn các bạn"] * 3, arpa,
                     order=3, char_level=False)
    rng = np.random.RandomState(7)
    signals = [(rng.randn(int(s * 16000)) * 0.1).astype(np.float32)
               for s in (1.3, 2.0, 3.7, 0.6, 5.2)]
    return yml, variables, arpa, signals


@pytest.mark.parametrize("decoder,dtype", [("greedy", None),
                                           ("greedy", "bfloat16"),
                                           ("device_beam", None)])
def test_transcriber_matches_jax(narrow, decoder, dtype):
    yml, variables, arpa, signals = narrow
    kw = dict(compute_dtype=dtype, decoder=decoder, beam_width=16,
              lm_path=arpa if decoder == "device_beam" else None)
    tr = Transcriber(yml, variables=variables, device="cpu",
                     options=TranscriberOptions(**kw))
    jtr = JaxTranscriber(yml, variables=jax.tree_util.tree_map(
        jnp.asarray, variables), options=JaxOptions(**kw))
    agree = []
    for s in signals:
        lp, el = tr.log_probs(s)
        jlp, jel = jtr.log_probs(s)
        np.testing.assert_array_equal(el, np.asarray(jel))
        tol = FP32_TOL if dtype is None else BF16_JIT_TOL
        assert valid_max_err(lp, np.asarray(jlp), el) <= tol
        agree.append(lp[0, :el[0]].argmax(-1)
                     == np.asarray(jlp)[0, :el[0]].argmax(-1))
    if dtype is None:
        got = tr.transcribe_batch(signals)
        assert got == jtr.transcribe_batch(signals)
        assert any(got)
    else:
        # JAX's Transcriber jits its bf16 forward (excess precision): the
        # frame argmax over the 5 signals (321 frames), the bf16 class
        assert np.mean(np.concatenate(agree)) >= ARGMAX_MIN


def test_transcriber_random_init_and_checkpoint(narrow, tmp_path):
    """With no weights, model_init under a Generator seeded 0; a msgpack
    variables file (flax's writer) gives the tree it holds."""
    from flax.serialization import msgpack_serialize

    yml, variables, _, signals = narrow
    a = Transcriber(yml, device="cpu")
    b = Transcriber(yml, device="cpu")
    assert a.transcribe(signals[1]) == b.transcribe(signals[1])
    assert "bn" in a.variables["params"]["blocks"][0]["conv"]   # no fold
    path = str(tmp_path / "c.msgpack.gz")
    with gzip.open(path, "wb") as f:
        f.write(msgpack_serialize(variables))
    loaded = load_anchor(path)
    for x, y in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(x, y)
    got = Transcriber(yml, checkpoint=path, device="cpu")
    want = Transcriber(yml, variables=variables, device="cpu")
    np.testing.assert_array_equal(got.log_probs(signals[0])[0],
                                  want.log_probs(signals[0])[0])
    # params_from_jax / to_numpy carry the list-of-blocks tree both ways
    back = to_numpy(params_from_jax(variables, device="cpu"))
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(x, y)


def test_conformer_refusals(narrow, tmp_path):
    from scipy.io import wavfile

    from vietasr_tpu_torch.streaming import long_form_log_probs
    from vietasr_tpu_torch.train.loop import make_loss_fn

    yml, variables, _, signals = narrow
    tr = Transcriber(yml, variables=variables, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tr.calibrate_int8(signals[:2])
    cfg = load_config(yml)
    v = params_from_jax(variables, device="cpu")
    feats, lens = torch.zeros(1, 16, 80), torch.tensor([16])
    # training, remat and the loss run since the training slice; a
    # QuartzNet refuses remat
    for kw in ({"training": True}, {"training": True, "remat": True}):
        assert len(P.conformer_apply(v, feats, lens, cfg=cfg.conformer,
                                     **kw)) == 3
    make_loss_fn(cfg, device="cpu", remat=True)
    with pytest.raises(ValueError, match="Conformer only"):
        make_loss_fn(dataclasses.replace(cfg, architecture="quartznet"),
                     device="cpu", remat=True)
    with pytest.raises(NotImplementedError, match="QuartzNet"):
        Transcriber(yml, encoder_checkpoint="enc.pt", device="cpu")
    from vietasr_tpu_torch.models.convert import (encoder_from_state_dict,
                                                  state_dict_from_variables)
    with pytest.raises(ValueError, match="QuartzNet"):
        encoder_from_state_dict({}, cfg.encoder)
    with pytest.raises(ValueError, match="QuartzNet"):
        state_dict_from_variables(variables, cfg.encoder)
    # long-form runs, stitched on the 4x subsampling
    # (test_torch_streaming_conformer.py holds it to JAX)
    long = (np.random.RandomState(3).randn(20 * 16000) * 0.1) \
        .astype(np.float32)
    text = tr.transcribe_long(long)
    assert tr.transcribe_long_batch([long]) == [text]
    lp, total = long_form_log_probs(tr, long, chunk_seconds=15.0,
                                    overlap_seconds=2.0)
    assert total == lp.shape[0] == int(tr.log_probs(long)[1][0]) == 500
    wav = str(tmp_path / "long.wav")
    wavfile.write(wav, 16000, (long * 32767).astype(np.int16))
    assert isinstance(tr.transcribe_file(wav), str)
    short = str(tmp_path / "short.wav")
    wavfile.write(short, 16000, (signals[2] * 32767).astype(np.int16))
    assert isinstance(tr.transcribe_file(short), str)


def test_upload_serves_a_conformer(narrow):
    """AsrServer's /upload over a Conformer Transcriber: up to the last
    bucket the transcript equals `transcribe` of the samples it reads;
    past it, `transcribe_long` of them."""
    import json
    import urllib.error
    import urllib.request

    from test_torch_serve import wav_bytes

    from vietasr_tpu_torch.audio.io import read_wav
    from vietasr_tpu_torch.serve import AsrServer

    yml, variables, _, signals = narrow
    tr = Transcriber(yml, variables=variables, device="cpu",
                     options=TranscriberOptions(compute_dtype=None))
    srv = AsrServer(tr, host="127.0.0.1", port=0).start(background=True)
    try:
        url = f"http://127.0.0.1:{srv.port}/upload"
        data = wav_bytes(signals[4])
        with urllib.request.urlopen(urllib.request.Request(
                url, data=data, method="POST")) as r:
            out = json.load(r)
        assert out["transcript"] == tr.transcribe(read_wav(data)[0])
        long = wav_bytes((np.random.RandomState(5).randn(17 * 16000)
                          * 0.1).astype(np.float32))
        with urllib.request.urlopen(urllib.request.Request(
                url, data=long, method="POST")) as r:
            out = json.load(r)
        assert out["transcript"] == tr.transcribe_long(read_wav(long)[0])
    finally:
        srv.stop()
