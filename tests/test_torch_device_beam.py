"""vietasr_tpu_torch's device beam tier against the JAX package's on the
CPU: the same numpy log-probs through vietasr_tpu.ops.device_beam /
pallas_beam (interpret mode) and their port.

Decoded ids and lengths must be identical. The raw packed state matches in
every hash and integer column; its float columns are held to 1e-6
relative: XLA's and PyTorch's CPU exp/log differ in the last bit
(measured 1.3e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vietasr_tpu.ops import device_beam as jdb
from vietasr_tpu.ops import lm as jlm
from vietasr_tpu.ops.pallas_beam import (dense_lm_from_tables,
                                         pallas_beam_search)
from vietasr_tpu_torch.ops import device_beam as tdb
from vietasr_tpu_torch.ops import lm as tlm
from vietasr_tpu_torch.ops.fused_beam import fused_beam_search

torch.set_num_threads(1)

LABELS = ["a", "b", "c", " "]
SPACE = LABELS.index(" ")
BLANK = len(LABELS)
WORD_CORPUS = ["ab cab ba c", "ab ba cab ba", "cab ab ba c ab",
               "ba cab ab ba", "c ab ba cab", "ab ba c cab ab"] * 2
CHAR_CORPUS = ["abc ab", "abc abc", "ab abc", "cab"] * 3
FLOAT_COLS = (tdb.C_PB, tdb.C_PNB, tdb.C_LM)


def softmax_logs(rng, t, v, scale=2.0):
    logits = rng.randn(t, v).astype(np.float32) * scale
    return np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))


@pytest.fixture(scope="module")
def word_lms(tmp_path_factory):
    """order -> (JAX tables, probes, port tables on the CPU)."""
    out = {}
    for order in (2, 3, 5):
        p = tmp_path_factory.mktemp("wlm") / f"word{order}.arpa"
        jlm.train_ngram_arpa(WORD_CORPUS, str(p), order=order)
        jt, probes = jlm.word_lm_tables(jlm.NGramLM(str(p)), LABELS)
        tt, _ = tlm.word_lm_tables(tlm.NGramLM(str(p)), LABELS)
        out[order] = (jt, probes, tdb.word_lm_to_device(tt, "cpu"))
    return out


@pytest.fixture(scope="module")
def char_table(tmp_path_factory):
    p = tmp_path_factory.mktemp("clm") / "char.arpa"
    jlm.train_ngram_arpa(CHAR_CORPUS, str(p), order=3, char_level=True)
    return jlm.char_lm_table(jlm.NGramLM(str(p)), LABELS)


def _inputs(seed, lens, t=14, scale=1.8):
    rng = np.random.RandomState(seed)
    lp = np.stack([softmax_logs(rng, t, BLANK + 1, scale) for _ in lens])
    return lp, np.asarray(lens, np.int32)


def _both(lp, lens, *, word_lm=None, lm_table=None, return_raw=False, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if word_lm is not None:
        jt, probes, tt = word_lm
        jkw.update(word_lm=jt, wlm_probes=probes)
        tkw.update(word_lm=tt, wlm_probes=probes)
    if lm_table is not None:
        jkw.update(lm_table=jnp.asarray(lm_table), n_ctx=2)
        tkw.update(lm_table=torch.from_numpy(lm_table), n_ctx=2)
    want = jdb.device_beam_search(jnp.asarray(lp), jnp.asarray(lens),
                                  blank=BLANK, return_raw=return_raw, **jkw)
    got = tdb.device_beam_search(torch.from_numpy(lp),
                                 torch.from_numpy(lens), blank=BLANK,
                                 return_raw=return_raw, **tkw)
    return [np.asarray(a) for a in want], [g.numpy() for g in got]


def _assert_same_decode(want, got):
    (w_ids, w_lens), (g_ids, g_lens) = want, got
    assert g_ids.dtype == np.int32 and g_lens.dtype == np.int32
    np.testing.assert_array_equal(g_lens, w_lens)
    np.testing.assert_array_equal(g_ids, w_ids)


CASES = [
    # (name, kwargs, lengths)
    ("raw_w8", dict(beam_width=8), [14, 9, 1]),
    ("raw_w12_cut3", dict(beam_width=12, cutoff_top_n=3), [14, 1]),
    ("canon_w8_cut3", dict(beam_width=8, cutoff_top_n=3, space=SPACE),
     [14, 6, 1]),
    ("canon_w12", dict(beam_width=12, space=SPACE), [14, 11]),
    ("canon_w48_cut4", dict(beam_width=48, cutoff_top_n=4, space=SPACE),
     [14, 1]),
    ("char_w8", dict(beam_width=8, alpha=0.6, beta=0.2, lm="char"),
     [14, 5, 1]),
    ("char_w12_cut3", dict(beam_width=12, cutoff_top_n=3, alpha=0.6,
                           beta=0.2, lm="char"), [14, 8]),
    ("word2_w8_cut4", dict(beam_width=8, cutoff_top_n=4, lm=2), [14, 7, 1]),
    ("word3_w12_cut3", dict(beam_width=12, cutoff_top_n=3, lm=3), [14, 1]),
    ("word3_w48", dict(beam_width=48, lm=3), [14, 10]),
    ("word5_w8", dict(beam_width=8, lm=5), [14, 12, 1]),
    ("word5_w48_cut4", dict(beam_width=48, cutoff_top_n=4, lm=5), [14, 9]),
]


@pytest.mark.parametrize("name,kw,lens", CASES, ids=[c[0] for c in CASES])
def test_device_beam_search_matches_jax(name, kw, lens, word_lms,
                                        char_table):
    kw = dict(kw)
    lm = kw.pop("lm", None)
    extra = {}
    if lm == "char":
        extra["lm_table"] = char_table
    elif lm is not None:
        extra.update(word_lm=word_lms[lm], space=SPACE, alpha=0.5, beta=1.5)
    lp, lens = _inputs(sum(map(ord, name)), lens)
    _assert_same_decode(*_both(lp, lens, **kw, **extra))


@pytest.mark.parametrize("order", [3, 5])
def test_raw_state_and_backpointers_match_jax(order, word_lms):
    lp, lens = _inputs(70 + order, [14, 8, 1])
    (w_st, w_par, w_ch), (g_st, g_par, g_ch) = _both(
        lp, lens, word_lm=word_lms[order], beam_width=12, cutoff_top_n=4,
        space=SPACE, alpha=0.5, beta=1.5, return_raw=True)
    np.testing.assert_array_equal(g_par, w_par)
    np.testing.assert_array_equal(g_ch, w_ch)
    w_st = w_st.view(np.int32)
    assert g_st.shape == w_st.shape and g_st.dtype == np.int32
    ints = [c for c in range(w_st.shape[-1]) if c not in FLOAT_COLS]
    np.testing.assert_array_equal(g_st[..., ints], w_st[..., ints])
    np.testing.assert_allclose(g_st[..., FLOAT_COLS].view(np.float32),
                               w_st[..., FLOAT_COLS].view(np.float32),
                               rtol=1e-6)


def test_init_state_and_totals_match_jax(word_lms):
    jt, probes, tt = word_lms[3]
    want = np.asarray(jdb.init_packed_state(2, 6, jt)).view(np.int32)
    np.testing.assert_array_equal(tdb.init_packed_state(2, 6, tt).numpy(),
                                  want)
    lp, lens = _inputs(5, [14, 6])
    (w_st, _, _), (g_st, _, _) = _both(
        lp, lens, word_lm=word_lms[3], beam_width=8, cutoff_top_n=4,
        space=SPACE, alpha=0.5, beta=1.5, return_raw=True)
    want = np.asarray(jdb.packed_beam_totals(
        jnp.asarray(w_st), word_lm=jt, alpha=0.5, beta=1.5,
        wlm_probes=probes))
    st = torch.from_numpy(g_st)
    got = tdb.packed_beam_totals(st, word_lm=tt, alpha=0.5, beta=1.5,
                                 wlm_probes=probes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the dense and the probing lookup agree bit for bit on every beam
    ctx = [(tdb._u(st[..., tdb.C_CTX + 2 * j]),
            tdb._u(st[..., tdb.C_CTX + 2 * j + 1])) for j in range(2)]
    bos = [tdb._f(st[..., tdb.C_CTX + 4 + j]) for j in range(2)]
    wh = (tdb._u(st[..., tdb.C_WH1]), tdb._u(st[..., tdb.C_WH2]))
    dense = tdb._word_lm_score(tt, probes, ctx, *wh, bos, dense=True)
    probe = tdb._word_lm_score(tt, probes, ctx, *wh, bos, dense=False)
    assert torch.equal(dense[0], probe[0])
    assert all(torch.equal(a, b) for a, b in zip(dense[1], probe[1]))


def test_word_lm_score_matches_ngram_lm(word_lms, tmp_path):
    """The port's backoff-chain lookup == NGramLM.log_prob for every
    (context, word) over the vocab plus an OOV word."""
    p = tmp_path / "w3.arpa"
    tlm.train_ngram_arpa(WORD_CORPUS, str(p), order=3)
    lm = tlm.NGramLM(str(p))
    _, probes, tt = word_lms[3]
    cid = {ch: i for i, ch in enumerate(LABELS)}

    def whash(word):
        h1 = h2 = 0
        for ch in word:
            h1 = (h1 * 1000003 + cid[ch] + 1) & 0xFFFFFFFF
            h2 = (h2 * 69069 + cid[ch] + 1) & 0xFFFFFFFF
        return torch.tensor([h1]), torch.tensor([h2])

    for ctx in [(), ("ab",), ("cab", "ab"), ("bbb",), ("bbb", "ab")]:
        for w in ["ab", "ba", "cab", "c", "bbb"]:
            pairs = [whash(c) for c in reversed(ctx)]
            absent = (torch.tensor([0]), torch.tensor([0]))
            pairs += [absent] * (2 - len(pairs))
            bos = []
            for j in (1, 2):
                g = tuple(ctx[-j:]) if len(ctx) >= j else None
                bos.append(torch.tensor(
                    [lm.ngrams.get(g, (0.0, 0.0))[1] if g else 0.0],
                    dtype=torch.float32))
            for dense in (False, True):
                got, _ = tdb._word_lm_score(tt, probes, pairs, *whash(w),
                                            bos, dense=dense)
                assert abs(float(got[0]) - lm.log_prob(w, ctx)) < 1e-4


def test_reconstruct_best_path_matches_jax():
    rng = np.random.RandomState(3)
    for t, bsz, w, l_max in ((9, 3, 5, 0), (17, 2, 8, 6), (1, 2, 4, 3),
                             (33, 4, 16, 40)):
        parents = rng.randint(0, w, size=(t, bsz, w)).astype(np.int32)
        chars = rng.randint(-1, 4, size=(t, bsz, w)).astype(np.int32)
        best = rng.randint(0, w, size=(bsz,)).astype(np.int32)
        l_max = l_max or t
        want = jdb.reconstruct_best_path(
            jnp.asarray(parents), jnp.asarray(chars), jnp.asarray(best),
            w=w, bsz=bsz, t_max=t, l_max=l_max)
        got = tdb.reconstruct_best_path(
            torch.from_numpy(parents), torch.from_numpy(chars),
            torch.from_numpy(best), w=w, bsz=bsz, t_max=t, l_max=l_max)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("width,lm", [(8, True), (12, False)])
def test_fused_beam_search_cpu_matches_pallas(width, lm, word_lms):
    """The kernel's plain version (CPU tensors) against the Pallas kernel
    in interpret mode, as tests/test_pallas_beam.py runs it."""
    jt, probes, tt = word_lms[3]
    lp, lens = _inputs(900 + width, [14, 7])
    kw = dict(beam_width=width, cutoff_top_n=4 if lm else 3, space=SPACE,
              alpha=0.5, beta=1.5)
    pk = dict(kw)
    if lm:
        unk = float(np.asarray(jt.unk_logp))
        pk.update(dense_lm=dense_lm_from_tables(jt, unk), unk_logp=unk)
    want = pallas_beam_search(jnp.asarray(lp), jnp.asarray(lens),
                              blank=BLANK, interpret=True, **pk)
    launches = fused_beam_search.launches
    got = fused_beam_search(torch.from_numpy(lp), torch.from_numpy(lens),
                            blank=BLANK, word_lm=tt if lm else None,
                            wlm_probes=probes, **kw)
    assert fused_beam_search.launches == launches   # no kernel on the CPU
    w_ids, w_lens = (np.asarray(a) for a in want)
    g_ids, g_lens = (g.numpy() for g in got)
    np.testing.assert_array_equal(g_lens, w_lens)
    for b in range(len(lens)):
        np.testing.assert_array_equal(g_ids[b, :g_lens[b]],
                                      w_ids[b, :w_lens[b]])


def test_fused_beam_search_refuses_what_the_kernel_does_not_take():
    lp = torch.zeros((1, 4, 5))
    lens = torch.tensor([4], dtype=torch.int32)
    for kw in (dict(space=-1), dict(space=SPACE, cutoff_top_n=0),
               dict(space=SPACE, beam_width=129)):
        with pytest.raises(ValueError):
            fused_beam_search(lp, lens, blank=BLANK, **kw)


def test_transcripts_and_routing_match_jax(word_lms, monkeypatch):
    """device_beam_transcripts renders the same text as JAX's; eligible
    calls go through fused_beam_search, the rest do not."""
    import vietasr_tpu_torch.ops.fused_beam as fb

    jt, probes, tt = word_lms[3]
    lp, lens = _inputs(11, [12, 6], t=12)
    calls = []
    real = fb.fused_beam_search

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(fb, "fused_beam_search", spy)
    for kw, routed in ((dict(beam_width=8, cutoff_top_n=4, space=SPACE,
                             alpha=0.5, beta=1.5, wlm=True), True),
                       (dict(beam_width=8, cutoff_top_n=0, space=SPACE),
                        False),
                       (dict(beam_width=8, cutoff_top_n=4), False)):
        calls.clear()
        use_lm = kw.pop("wlm", False)
        want = jdb.device_beam_transcripts(
            lp, lens, LABELS, impl="xla",
            **kw, **(dict(word_lm=jt, wlm_probes=probes) if use_lm else {}))
        got = tdb.device_beam_transcripts(
            lp, lens, LABELS,
            **kw, **(dict(word_lm=tt, wlm_probes=probes) if use_lm else {}))
        assert got == want
        assert bool(calls) == routed


def test_carry_state_resume_matches_jax(word_lms):
    """Two chunks, the second resumed from the first's packed state (the
    streaming hook), give the same state and backpointers as JAX's."""
    jt, probes, tt = word_lms[3]
    lp, lens = _inputs(21, [14, 14])
    kw = dict(beam_width=8, cutoff_top_n=4, space=SPACE, alpha=0.5,
              beta=1.5, blank=BLANK, wlm_probes=probes, return_raw=True)
    j_st, t_st = None, None
    for lo, hi in ((0, 8), (8, 14)):
        chunk_lens = np.full((2,), hi - lo, np.int32)
        j_st, j_par, j_ch = jdb.device_beam_search(
            jnp.asarray(lp[:, lo:hi]), jnp.asarray(chunk_lens), word_lm=jt,
            carry_state=j_st, **kw)
        t_st, t_par, t_ch = tdb.device_beam_search(
            torch.from_numpy(lp[:, lo:hi]), torch.from_numpy(chunk_lens),
            word_lm=tt, carry_state=t_st, **kw)
        np.testing.assert_array_equal(t_par.numpy(), np.asarray(j_par))
        np.testing.assert_array_equal(t_ch.numpy(), np.asarray(j_ch))
    want = np.asarray(j_st).view(np.int32)
    ints = [c for c in range(want.shape[-1]) if c not in FLOAT_COLS]
    np.testing.assert_array_equal(t_st.numpy()[..., ints], want[..., ints])
