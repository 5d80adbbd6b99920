"""vietasr_tpu_torch int8 serving (models/quantize.py, the `pw_fn` hook of
quartznet_apply, Transcriber.calibrate_int8) vs the JAX package's, on the
CPU, on the same seeded weights and features.

Tolerances, with the values measured when they were set:
- quantize_weight / quantize_quartznet: w_i8 equal; w_scale and x_scale
  equal bit for bit (measured: equal; "to the ulp" is the bar).
- calibration: the same tags; each abs-max within 1e-6 relative of JAX's
  (fp32 sums in another order; measured 8.3e-8 fp32, 7.0e-8 bf16).
- the int8 forward on JAX's own tables (q_tables_from_jax) vs JAX's
  int8_pw_fn forward: max |d log p| <= 1e-4 in fp32 (measured 4.8e-7),
  <= 0.05 in bf16 (a bf16 rounding flip upstream can move an int8 code
  by one step; measured 0); argmax equal.
- int8 vs float: JAX's own bars (tests/test_quantize.py): argmax
  agreement > 0.95, max |d log p| < 0.35.
- full width (QuartzNet12x1_vi anchor, bf16): calibrate_int8 gives JAX's
  28 tags (14 sub, 13 res, dec) and equal w_i8; w_scale within 4 ulp
  (the two packages' BN folds differ by up to 4 ulp at this width;
  measured 3), x_scale within 2^-7 relative (a bf16 abs-max one rounding
  step apart; measured 5.1e-3). The int8 forward, on JAX's tables and on
  its own: lengths equal, frame argmax agreement >= 0.99 with JAX's int8
  Transcriber (measured 1.0 on JAX's tables, >= 0.995 on its own), as
  JAX's own int8 Transcriber test holds argmax only: an int8 code that
  flips by one step where fp32 sums in another order land near a
  half-way point moves the log-probs by up to ~0.6 (measured 0.60).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vietasr_tpu.config import BlockConfig as JaxBlock
from vietasr_tpu.config import EncoderConfig as JaxEncoder
from vietasr_tpu.models.quantize import \
    calibrate_activations as jax_calibrate
from vietasr_tpu.models.quantize import int8_pw_fn as jax_int8_pw_fn
from vietasr_tpu.models.quantize import quantize_quartznet as jax_quantize
from vietasr_tpu.models.quantize import quantize_weight as jax_qweight
from vietasr_tpu.models.quartznet import fold_batchnorm as jax_fold
from vietasr_tpu.models.quartznet import init_quartznet as jax_init
from vietasr_tpu.models.quartznet import quartznet_apply as jax_apply
from vietasr_tpu_torch.config import BlockConfig, EncoderConfig
from vietasr_tpu_torch.models import quartznet as port_quartznet
from vietasr_tpu_torch.models.convert import (load_anchor, params_from_jax,
                                              q_tables_from_jax)
from vietasr_tpu_torch.models.quantize import (EXACT_K,
                                               calibrate_activations,
                                               int8_matmul,
                                               int8_matmul_plain, int8_pw_fn,
                                               quantize_quartznet,
                                               quantize_weight,
                                               quantized_apply_fn)
from vietasr_tpu_torch.models.quartznet import quartznet_apply

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")

# JAX's tests/test_quantize.py small_cfg (strided, residual repeat-2 and
# plain separable blocks) plus a dense 1x1 block as QuartzNet12x1 ends
BLOCKS = [dict(filters=32, repeat=1, kernel=7, stride=2, residual=False,
               separable=True),
          dict(filters=64, repeat=2, kernel=5, residual=True,
               separable=True),
          dict(filters=96, repeat=1, kernel=3, residual=False,
               separable=True),
          dict(filters=48, repeat=1, kernel=1, residual=False,
               separable=False)]
FEAT_IN, N_CLASSES = 16, 8
TAGS = {"enc0.sub0", "enc1.sub0", "enc1.sub1", "enc1.res0", "enc2.sub0",
        "dec"}
DTYPES = [pytest.param(None, None, 1e-4, id="fp32"),
          pytest.param(jnp.bfloat16, torch.bfloat16, 0.05, id="bf16")]


def _model(seed=0):
    jcfg = JaxEncoder(blocks=tuple(JaxBlock(**b) for b in BLOCKS),
                      feat_in=FEAT_IN, activation="relu")
    pcfg = EncoderConfig(blocks=tuple(BlockConfig(**b) for b in BLOCKS),
                         feat_in=FEAT_IN)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_fold(jax_init(jax.random.PRNGKey(seed), jcfg,
                                      N_CLASSES), jcfg))
    return variables, jcfg, params_from_jax(variables, device="cpu"), pcfg


def _feats(bsz=3, t=64, seed=1):
    rng = np.random.RandomState(seed)
    feats = rng.randn(bsz, t, FEAT_IN).astype(np.float32)
    lens = np.array([t, t - 7, t // 2][:bsz], np.int32)
    return feats, lens


def _tables_equal(got, want):
    assert set(got) == set(want)
    for tag in want:
        w_i8, w_scale, x_scale = (np.asarray(a) for a in want[tag])
        np.testing.assert_array_equal(got[tag].w_i8.numpy(), w_i8)
        np.testing.assert_array_equal(got[tag].w_scale.numpy(), w_scale)
        np.testing.assert_array_equal(got[tag].x_scale.numpy(), x_scale)


def test_quantize_weight_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(48, 32).astype(np.float32) * np.exp(
        rng.randn(32)).astype(np.float32)   # very different channel scales
    want_i8, want_scale = jax_qweight(jnp.asarray(w))
    got_i8, got_scale = quantize_weight(torch.from_numpy(w))
    assert got_i8.dtype == torch.int8
    np.testing.assert_array_equal(got_i8.numpy(), np.asarray(want_i8))
    np.testing.assert_array_equal(got_scale.numpy(), np.asarray(want_scale))


def test_quantize_weight_rounds_half_to_even():
    """A weight exactly half-way between two codes rounds to the even
    code, as jnp.round does: scale 1 (amax 127), 2.5 -> 2, 3.5 -> 4."""
    w = np.array([[2.5, 3.5], [-2.5, -0.5], [127.0, 127.0]], np.float32)
    got, _ = quantize_weight(torch.from_numpy(w))
    want, _ = jax_qweight(jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:2].tolist() == [[2, 4], [-2, 0]]


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_calibration_matches_jax(jdt, tdt, tol):
    variables, jcfg, pvars, pcfg = _model()
    feats, lens = _feats()
    want = jax_calibrate(variables, jcfg, jnp.asarray(feats),
                         jnp.asarray(lens), compute_dtype=jdt)
    got = calibrate_activations(pvars, pcfg, torch.from_numpy(feats),
                                torch.from_numpy(lens), compute_dtype=tdt)
    assert set(got) == set(want) == TAGS
    for tag in want:
        assert abs(got[tag] - want[tag]) <= 1e-6 * want[tag], tag


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_quantize_quartznet_matches_jax(jdt, tdt, tol):
    """From the same abs-maxes, the tables are JAX's exactly."""
    variables, jcfg, pvars, pcfg = _model()
    feats, lens = _feats()
    amax = jax_calibrate(variables, jcfg, jnp.asarray(feats),
                         jnp.asarray(lens), compute_dtype=jdt)
    _tables_equal(quantize_quartznet(pvars, pcfg, amax),
                  jax_quantize(variables, jcfg, amax))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_int8_forward_on_jax_tables_matches_jax(jdt, tdt, tol):
    variables, jcfg, pvars, pcfg = _model()
    feats, lens = _feats()
    amax = jax_calibrate(variables, jcfg, jnp.asarray(feats),
                         jnp.asarray(lens), compute_dtype=jdt)
    tables = jax_quantize(variables, jcfg, amax)
    want, want_lens, _ = jax_apply(variables, jnp.asarray(feats),
                                   jnp.asarray(lens), cfg=jcfg,
                                   compute_dtype=jdt,
                                   pw_fn=jax_int8_pw_fn(tables))
    got, got_lens = quartznet_apply(
        pvars, torch.from_numpy(feats), torch.from_numpy(lens), cfg=pcfg,
        compute_dtype=tdt,
        pw_fn=int8_pw_fn(q_tables_from_jax(tables, device="cpu")))
    want = np.asarray(want)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= tol
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_int8_forward_close_to_float(jdt, tdt, tol):
    """JAX's own bars for int8 vs float on a random-init model."""
    _, _, pvars, pcfg = _model()
    feats, lens = _feats(t=64)
    feats, lens = torch.from_numpy(feats), torch.from_numpy(lens)
    tables = quantize_quartznet(pvars, pcfg, calibrate_activations(
        pvars, pcfg, feats, lens, compute_dtype=tdt))
    lp_f, lens_f = quartznet_apply(pvars, feats, lens, cfg=pcfg,
                                   compute_dtype=tdt)
    lp_q, lens_q = quartznet_apply(pvars, feats, lens, cfg=pcfg,
                                   compute_dtype=tdt,
                                   pw_fn=int8_pw_fn(tables))
    assert torch.equal(lens_f, lens_q)
    agree = float((lp_f.argmax(-1) == lp_q.argmax(-1)).double().mean())
    assert agree > 0.95, agree
    assert float((lp_f - lp_q).abs().max()) < 0.35


def test_quantized_apply_fn_runs_bf16():
    _, _, pvars, pcfg = _model()
    feats, lens = (torch.from_numpy(a) for a in _feats())
    tables = quantize_quartznet(pvars, pcfg, calibrate_activations(
        pvars, pcfg, feats, lens))
    lp, out_lens = quantized_apply_fn(pvars, pcfg, tables)(feats, lens)
    assert lp.shape[-1] == N_CLASSES + 1 and lp.dtype == torch.float32
    assert bool(torch.isfinite(lp).all())
    np.testing.assert_allclose(lp.double().exp().sum(-1).numpy(), 1.0,
                               atol=1e-2)


def test_pw_fn_sees_jax_tags_in_jax_order():
    """The hook's call sites and tags are JAX's, in the same order."""
    variables, jcfg, pvars, pcfg = _model()
    feats, lens = _feats()
    seen = {"jax": [], "port": []}

    def recorder(key, conv):
        def pw(tag, x, w):
            seen[key].append(tag)
            return conv(x, w)
        return pw

    jax_apply(variables, jnp.asarray(feats), jnp.asarray(lens), cfg=jcfg,
              pw_fn=recorder("jax", lambda x, w: jnp.einsum(
                  "btc,cd->btd", x, w, preferred_element_type=jnp.float32)))
    quartznet_apply(pvars, torch.from_numpy(feats), torch.from_numpy(lens),
                    cfg=pcfg, pw_fn=recorder("port", lambda x, w: x.float()
                                             @ w.float()))
    assert seen["port"] == seen["jax"]
    assert set(seen["port"]) == TAGS


@pytest.mark.parametrize("block_impl", ["auto", "kernel", "plain"])
def test_pw_fn_turns_the_repeat_route_off(monkeypatch, block_impl):
    """bf16 with the default pw_fn sends the two eligible blocks (1: R =
    2 with a residual, 2: stride 1) through the repeat-block route; any
    other pw_fn runs every block per-op, as JAX's `pw_fn is _default_pw`
    condition does."""
    _, _, pvars, pcfg = _model()
    feats, lens = (torch.from_numpy(a) for a in _feats())
    routed = []
    for name in ("fused_repeat_block", "fused_repeat_block_plain"):
        real = getattr(port_quartznet, name)
        monkeypatch.setattr(port_quartznet, name,
                            lambda *a, _real=real, **k: (routed.append(1),
                                                         _real(*a, **k))[1])
    quartznet_apply(pvars, feats, lens, cfg=pcfg,
                    compute_dtype=torch.bfloat16, block_impl=block_impl)
    assert len(routed) == 2
    routed.clear()
    quartznet_apply(pvars, feats, lens, cfg=pcfg,
                    compute_dtype=torch.bfloat16, block_impl=block_impl,
                    pw_fn=lambda tag, x, w: x.float() @ w.float())
    assert routed == []


@pytest.mark.parametrize("k", [8, 64, 1024, EXACT_K])
def test_int8_matmul_plain_is_exact(k):
    """The plain int8 GEMM equals numpy's int64 product at the extremes
    (every entry +-127: partial sums up to 127 * 127 * K < 2^24) and on
    random codes; the CPU wrapper takes it."""
    rng = np.random.RandomState(k)
    for x, w in ((np.full((5, k), 127, np.int8),
                  np.full((k, 16), -127, np.int8)),
                 (rng.randint(-127, 128, (33, k)).astype(np.int8),
                  rng.randint(-127, 128, (k, 24)).astype(np.int8))):
        want = x.astype(np.int64) @ w.astype(np.int64)
        got = int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
            want)
    with pytest.raises(ValueError, match="exact"):
        int8_matmul_plain(torch.zeros(2, EXACT_K + 1, dtype=torch.int8),
                          torch.zeros(EXACT_K + 1, 8, dtype=torch.int8))


@pytest.fixture(scope="module")
def full_width():
    """JAX's and the port's bf16 Transcribers on the anchor, each
    calibrated on the same three seeded signals (two buckets)."""
    from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
    from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
    from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

    anchor = load_anchor(ANCHOR)
    rng = np.random.RandomState(7)
    signals = [(rng.randn(n) * 0.1).astype(np.float32)
               for n in (20000, 30000, 52000)]
    jax_tr = JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions())
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions())
    float_lp = port.log_probs(signals[2])[0]
    jax_tr.calibrate_int8(signals)
    port.calibrate_int8(signals)
    return jax_tr, port, signals, float_lp


def test_full_width_calibrate_int8_matches_jax(full_width):
    jax_tr, port, _, _ = full_width
    want, got = jax_tr._q_tables, port._q_tables
    assert len(got) == 28
    assert set(got) == set(want) == (
        {f"enc{i}.sub0" for i in range(14)}
        | {f"enc{i}.res0" for i in range(1, 14)} | {"dec"})
    for tag in want:
        np.testing.assert_array_equal(got[tag].w_i8.numpy(),
                                      np.asarray(want[tag].w_i8))
        np.testing.assert_array_max_ulp(got[tag].w_scale.numpy(),
                                        np.asarray(want[tag].w_scale), 4)
        # x_scale from each side's own calibration forward (bf16)
        assert abs(float(got[tag].x_scale) - float(want[tag].x_scale)) \
            <= 2.0 ** -7 * float(want[tag].x_scale), tag


@pytest.mark.parametrize("tables", ["jax", "own"])
def test_full_width_int8_forward_matches_jax(full_width, tables):
    jax_tr, port, signals, float_lp = full_width
    own = port._q_tables
    if tables == "jax":
        port._q_tables = q_tables_from_jax(jax_tr._q_tables, device="cpu")
    try:
        for sig in signals:
            want, want_lens = jax_tr.log_probs(sig)
            got, got_lens = port.log_probs(sig)
            np.testing.assert_array_equal(got_lens, want_lens)
            assert np.isfinite(got).all()
            assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
        # int8 vs the port's bf16 float forward: JAX's argmax bar
        assert (got.argmax(-1) == float_lp.argmax(-1)).mean() > 0.95
    finally:
        port._q_tables = own
