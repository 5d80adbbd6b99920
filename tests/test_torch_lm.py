"""vietasr_tpu_torch.ops.lm against vietasr_tpu.ops.lm on the same text:
ARPA files byte-identical, scores to 1e-6, device tables bit-identical."""

import numpy as np
import pytest

from vietasr_tpu.ops import lm as jlm
from vietasr_tpu.ops.kenlm_binary import write_kenlm_binary
from vietasr_tpu_torch.ops import lm as tlm

WORD_CORPUS = ["ab cab ba c", "ab ba cab ba", "cab ab ba c ab",
               "ba cab ab ba", "c ab ba cab", "ab ba c cab ab"] * 2
CHAR_CORPUS = ["abc ab", "abc abc", "ab abc", "cab"] * 3
LABELS = ["a", "b", "c", " "]


def _arpa_pair(tmp_path, corpus, **kw):
    a, b = tmp_path / "jax.arpa", tmp_path / "port.arpa"
    jlm.train_ngram_arpa(corpus, str(a), **kw)
    tlm.train_ngram_arpa(corpus, str(b), **kw)
    return a, b


@pytest.mark.parametrize("order,char_level", [(2, False), (3, False),
                                              (5, False), (3, True)])
def test_train_ngram_arpa_bytes_equal(tmp_path, order, char_level):
    a, b = _arpa_pair(tmp_path, CHAR_CORPUS if char_level else WORD_CORPUS,
                      order=order, char_level=char_level)
    assert a.read_bytes() == b.read_bytes()


def test_log_prob_matches(tmp_path):
    a, _ = _arpa_pair(tmp_path, WORD_CORPUS, order=3)
    jm, tm = jlm.NGramLM(str(a)), tlm.NGramLM(str(a))
    assert (tm.order, tm.vocab, tm.has_unk) == (jm.order, jm.vocab,
                                                jm.has_unk)
    words = ["ab", "ba", "cab", "c", "bbb", "</s>"]
    ctxs = [(), ("<s>",), ("ab",), ("cab", "ab"), ("bbb", "ba"),
            ("c", "c", "c")]
    for ctx in ctxs:
        for w in words:
            assert abs(tm.log_prob(w, ctx) - jm.log_prob(w, ctx)) <= 1e-6
    sent = ["ab", "cab", "ba"]
    assert abs(tm.score_sentence(sent) - jm.score_sentence(sent)) <= 1e-6


def test_gzip_arpa_and_write_arpa(tmp_path):
    import gzip

    a, _ = _arpa_pair(tmp_path, WORD_CORPUS, order=3)
    gz = tmp_path / "lm.arpa.gz"
    gz.write_bytes(gzip.compress(a.read_bytes()))
    assert tlm.NGramLM(str(gz)).ngrams == jlm.NGramLM(str(a)).ngrams
    out_j, out_t = tmp_path / "j.arpa", tmp_path / "t.arpa"
    jlm.write_arpa(jlm.NGramLM(str(a)), str(out_j))
    tlm.write_arpa(tlm.NGramLM(str(a)), str(out_t))
    assert out_j.read_bytes() == out_t.read_bytes()


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_word_lm_tables_identical(tmp_path, order):
    a, _ = _arpa_pair(tmp_path, WORD_CORPUS, order=order)
    want, want_probes = jlm.word_lm_tables(jlm.NGramLM(str(a)), LABELS)
    got, got_probes = tlm.word_lm_tables(tlm.NGramLM(str(a)), LABELS)
    assert got_probes == want_probes
    for field in ("packed", "masks", "bases", "unk_logp"):
        w, g = np.asarray(getattr(want, field)), np.asarray(
            getattr(got, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), field


def test_word_lm_tables_refuse_order_6(tmp_path):
    a, _ = _arpa_pair(tmp_path, WORD_CORPUS, order=6)
    with pytest.raises(ValueError, match="order"):
        tlm.word_lm_tables(tlm.NGramLM(str(a)), LABELS)


def test_char_lm_table_identical(tmp_path):
    a, _ = _arpa_pair(tmp_path, CHAR_CORPUS, order=3, char_level=True)
    want = jlm.char_lm_table(jlm.NGramLM(str(a)), LABELS)
    got = tlm.char_lm_table(tlm.NGramLM(str(a)), LABELS)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for ctx in ([], [0], [0, 1], [3, 2, 1]):
        assert tlm.context_row_index(ctx, 4, 2) == \
            jlm.context_row_index(ctx, 4, 2)


def test_load_lm_reads_arpa_and_refuses_kenlm_binary(tmp_path):
    """load_lm reads an ARPA as JAX's does; a KenLM binary, which it once
    refused, now loads and scores as its ARPA (f32 storage) and as JAX's
    load_lm of the same binary (exactly)."""
    from vietasr_tpu_torch.ops.kenlm_binary import is_kenlm_binary

    a, _ = _arpa_pair(tmp_path, WORD_CORPUS, order=3)
    assert tlm.load_lm(str(a)).ngrams == jlm.load_lm(str(a)).ngrams
    binary = tmp_path / "lm.binary"
    write_kenlm_binary(str(a), str(binary))
    assert is_kenlm_binary(str(binary)) and not is_kenlm_binary(str(a))
    got, ref = tlm.load_lm(str(binary)), tlm.NGramLM(str(a))
    assert got.ngrams == jlm.load_lm(str(binary)).ngrams
    assert set(got.ngrams) == set(ref.ngrams) and got.order == ref.order
    for w, ctx in (("ab", ("ba",)), ("cab", ("ab", "ba")), ("zz", ("c",)),
                   ("c", ()), ("</s>", ("ab", "ba"))):
        assert got.log_prob(w, ctx) == pytest.approx(ref.log_prob(w, ctx),
                                                     rel=1e-6, abs=1e-6)
