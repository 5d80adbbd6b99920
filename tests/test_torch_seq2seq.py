"""The port's attention seq2seq (models/seq2seq.py) vs the JAX package's
on JAX's own weights carried across with `params_from_jax`: the GRU with
ragged lengths (and against torch.nn.GRU), attention, teacher forcing, the
greedy and beam generators token for token, the Jasper-to-RNN connector
in both modes and `las_evaluate`; then the copy task trained on the port
alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from vietasr_tpu.models import seq2seq as jax_s2s
from vietasr_tpu_torch.models import seq2seq as s2s
from vietasr_tpu_torch.models.convert import params_from_jax

GRU_TOL = 1e-5
ATTN_TOL = 1e-6
LOGP_TOL = 1e-5
SCORE_TOL = 1e-5


def _port(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def test_gru_matches_jax_with_ragged_lengths_and_holds_padded_steps():
    rng = np.random.RandomState(0)
    b, t, d, h = 4, 9, 5, 8
    jp = jax_s2s.init_encoder_rnn(jax.random.PRNGKey(0), d, h)
    x = rng.randn(b, t, d).astype(np.float32)
    lens = np.array([9, 4, 1, 0], np.int32)
    want, want_h = jax_s2s.encoder_rnn_apply(jp, jnp.asarray(x),
                                             jnp.asarray(lens))
    got, got_h = s2s.encoder_rnn_apply(_port(jp), torch.from_numpy(x),
                                       torch.from_numpy(lens))
    _close(got, want, GRU_TOL)
    _close(got_h, want_h, GRU_TOL)
    for i, n in enumerate(lens):
        # padded steps repeat the last valid state (zeros for length 0)
        assert torch.equal(got[i, n:], got_h[i].expand(t - n, h))
    assert not bool(got_h[3].any())


def test_gru_matches_torch_nn_gru():
    rng = np.random.RandomState(1)
    b, t, d, h = 2, 6, 4, 8
    jp = jax_s2s.init_encoder_rnn(jax.random.PRNGKey(1), d, h)
    p = _port(jp)
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32))
    gru = torch.nn.GRU(d, h, batch_first=True)
    gru.load_state_dict({"weight_ih_l0": p["gru"]["wi"].t(),
                         "weight_hh_l0": p["gru"]["wh"].t(),
                         "bias_ih_l0": p["gru"]["bi"],
                         "bias_hh_l0": p["gru"]["bh"]})
    with torch.no_grad():
        want, want_h = gru(x)
    got, got_h = s2s.encoder_rnn_apply(p, x, torch.tensor([t, t]))
    _close(got, want, GRU_TOL)
    _close(got_h, want_h[0], GRU_TOL)


def test_attention_matches_jax():
    rng = np.random.RandomState(2)
    jp = jax_s2s.init_attention(jax.random.PRNGKey(2), 8)
    q = rng.randn(3, 8).astype(np.float32)
    keys = rng.randn(3, 7, 8).astype(np.float32)
    lens = np.array([7, 2, 5], np.int32)
    want_ctx, want_w = jax_s2s.attention_apply(jp, jnp.asarray(q),
                                               jnp.asarray(keys),
                                               jnp.asarray(lens))
    ctx, w = s2s.attention_apply(_port(jp), torch.from_numpy(q),
                                 torch.from_numpy(keys),
                                 torch.from_numpy(lens))
    _close(w, want_w, ATTN_TOL)
    _close(ctx, want_ctx, ATTN_TOL)
    _close(w.sum(-1), np.ones(3), ATTN_TOL)
    assert float(w[1, 2:].max()) == 0.0


VOCAB, HIDDEN, ENC_T = 7, 16, 11
BOS, EOS = 1, 2


def _decoder_case(seed, eos_bias):
    """JAX's weights for a decoder whose eos logit is raised by
    `eos_bias` (so some rows finish early), encoder outputs, lengths and
    an initial state."""
    jp = jax_s2s.init_decoder_rnn(jax.random.PRNGKey(seed), VOCAB, HIDDEN)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    jp["out"]["b"] = jp["out"]["b"].copy()
    jp["out"]["b"][EOS] += eos_bias
    rng = np.random.RandomState(seed)
    enc = rng.randn(5, ENC_T, HIDDEN).astype(np.float32)
    lens = np.array([11, 7, 3, 11, 1], np.int32)
    h0 = (rng.randn(5, HIDDEN) * 0.5).astype(np.float32)
    return jp, enc, lens, h0


def _both(jp, enc, lens, h0):
    return ((jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(h0),
             jnp.asarray(enc), jnp.asarray(lens)),
            (_port(jp), torch.from_numpy(h0), torch.from_numpy(enc),
             torch.from_numpy(lens)))


def test_teacher_forced_log_probs_match_jax():
    jp, enc, lens, h0 = _decoder_case(3, 0.0)
    targets = np.random.RandomState(3).randint(0, VOCAB, size=(5, 8)) \
        .astype(np.int32)
    (ja, jh, je, jl), (pa, ph, pe, pl) = _both(jp, enc, lens, h0)
    want = jax_s2s.decoder_rnn_apply(ja, jnp.asarray(targets), jh, je, jl)
    got = s2s.decoder_rnn_apply(pa, torch.from_numpy(targets), ph, pe, pl)
    assert got.shape == (5, 8, VOCAB)
    _close(got, want, LOGP_TOL)


@pytest.mark.parametrize("seed,eos_bias", [(4, 0.0), (5, 1.2), (6, 2.0)])
def test_greedy_generate_matches_jax(seed, eos_bias):
    jp, enc, lens, h0 = _decoder_case(seed, eos_bias)
    (ja, jh, je, jl), (pa, ph, pe, pl) = _both(jp, enc, lens, h0)
    kw = dict(bos_id=BOS, eos_id=EOS, max_len=12)
    want_t, want_l = jax_s2s.greedy_generate(ja, jh, je, jl, **kw)
    got_t, got_l = s2s.greedy_generate(pa, ph, pe, pl, **kw)
    assert got_t.dtype == torch.int32
    assert np.array_equal(_np(got_t), _np(want_t))
    assert np.array_equal(_np(got_l), _np(want_l))
    if eos_bias:
        # rows that finished early: their length counts the eos step
        assert int(got_l.min()) < 12
        row = int(torch.argmin(got_l))
        assert int(got_t[row, int(got_l[row]) - 1]) == EOS


@pytest.mark.parametrize("width", [1, 4, 8])
@pytest.mark.parametrize("len_penalty", [0.0, 0.6])
@pytest.mark.parametrize("eos_bias", [0.0, 1.5])
def test_beam_generate_matches_jax(width, len_penalty, eos_bias):
    """W = 8 > V = 7 draws candidates of the dead initial beams (all
    exactly -1e30) on the first step: the ties go to the lower index, as
    jax.lax.top_k breaks them."""
    jp, enc, lens, h0 = _decoder_case(7, eos_bias)
    (ja, jh, je, jl), (pa, ph, pe, pl) = _both(jp, enc, lens, h0)
    kw = dict(bos_id=BOS, eos_id=EOS, max_len=10, beam_width=width,
              len_penalty=len_penalty)
    want_t, want_s = jax_s2s.beam_generate(ja, jh, je, jl, **kw)
    got_t, got_s = s2s.beam_generate(pa, ph, pe, pl, **kw)
    assert np.array_equal(_np(got_t), _np(want_t))
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=SCORE_TOL)
    if eos_bias:
        assert bool((got_t == EOS).any())


@pytest.mark.parametrize("width", [1, 2, 3])
def test_beam_ties_go_to_the_lower_index(width):
    """Tokens 3 and 4 with the same output column and bias tie exactly at
    every step: the beam keeps token 3 first, as jax.lax.top_k does."""
    jp, enc, lens, h0 = _decoder_case(10, 0.0)
    jp["out"]["w"] = jp["out"]["w"].copy()
    jp["out"]["w"][:, 4] = jp["out"]["w"][:, 3]
    jp["out"]["b"][3] = jp["out"]["b"][4] = 3.0
    (ja, jh, je, jl), (pa, ph, pe, pl) = _both(jp, enc, lens, h0)
    kw = dict(bos_id=BOS, eos_id=EOS, max_len=6, beam_width=width)
    want_t, want_s = jax_s2s.beam_generate(ja, jh, je, jl, **kw)
    got_t, got_s = s2s.beam_generate(pa, ph, pe, pl, **kw)
    assert np.array_equal(_np(got_t), _np(want_t))
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=SCORE_TOL)
    assert bool((got_t == 3).any())


def test_beam_width_one_is_greedy():
    jp, enc, lens, h0 = _decoder_case(8, 1.0)
    _, (pa, ph, pe, pl) = _both(jp, enc, lens, h0)
    g, _ = s2s.greedy_generate(pa, ph, pe, pl, bos_id=BOS, eos_id=EOS,
                               max_len=9)
    b, _ = s2s.beam_generate(pa, ph, pe, pl, bos_id=BOS, eos_id=EOS,
                             max_len=9, beam_width=1)
    assert torch.equal(g, b)


@pytest.mark.parametrize("training", [False, True])
def test_connector_matches_jax(training):
    rng = np.random.RandomState(9)
    jp = jax.tree_util.tree_map(
        np.asarray, jax_s2s.init_jasper_rnn_connector(jax.random.PRNGKey(9),
                                                      12, 8))
    jp["mean"] = rng.randn(8).astype(np.float32) * 0.1
    jp["var"] = rng.rand(8).astype(np.float32) + 0.5
    feats = rng.randn(3, 10, 12).astype(np.float32)
    lens = np.array([10, 6, 0], np.int32)
    want, want_p = jax_s2s.jasper_rnn_connector_apply(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(feats),
        jnp.asarray(lens), training=training)
    p = _port(jp)
    got, got_p = s2s.jasper_rnn_connector_apply(
        p, torch.from_numpy(feats), torch.from_numpy(lens),
        training=training)
    _close(got, want, 1e-5)
    assert not bool(got[1, 6:].any()) and not bool(got[2].any())
    for k in ("mean", "var"):
        _close(got_p[k], want_p[k], 1e-6)
    if training:
        assert got_p is not p and not torch.equal(got_p["mean"], p["mean"])
        assert torch.equal(p["mean"], torch.from_numpy(jp["mean"]))
    else:
        assert got_p is p


def test_las_evaluate_matches_jax():
    labels = [str(i) for i in range(8)]
    ids = np.array([[3, 4, 5, 2, 6],         # eos ends the row
                    [0, 3, 0, 7, 7],         # pads skipped, no eos
                    [2, 3, 3, 3, 3],         # empty hypothesis
                    [9, 3, 12, 4, 2]],       # ids outside the labels
                   np.int32)
    refs = ["345", "377", "1", "34"]
    want = jax_s2s.las_evaluate(jnp.asarray(ids), refs, labels, eos_id=2)
    for given in (torch.from_numpy(ids), ids):
        got = s2s.las_evaluate(given, refs, labels, eos_id=2)
        assert got == want
    assert got["hypotheses"] == ["345", "377", "", "34"]


def test_copy_task_converges():
    """JAX's copy-task check (tests/test_seq2seq.py) on the port, with
    the port's make_optimizer("adam", 5e-3): after 150 steps the loss is
    under 0.3 and greedy and beam accuracy above 0.8."""
    out = chip_smoke.copy_task(np, torch, torch.device("cpu"))
    assert out["loss"] < chip_smoke.COPY_LOSS_MAX, out
    assert out["greedy_acc"] > chip_smoke.COPY_ACC_MIN, out
    assert out["beam_acc"] > chip_smoke.COPY_ACC_MIN, out
    assert out["beam_scores_finite"]
