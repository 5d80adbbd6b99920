"""vietasr_tpu_torch.ops.kenlm_binary / kenlm_trie against the JAX package's
copies on the same ARPA models: the written PROBING, TRIE and QUANT_TRIE
binaries byte-identical, every score equal exactly (both readers compute
the same float64 sums of the same stored float32 values), the rebuilt
NGramLM equal key for key, and the device word-LM tables of a binary equal
element for element."""

import numpy as np
import pytest

from vietasr_tpu.ops import kenlm_binary as jkb
from vietasr_tpu.ops import kenlm_trie as jkt
from vietasr_tpu.ops import lm as jlm
from vietasr_tpu_torch.ops import kenlm_binary as tkb
from vietasr_tpu_torch.ops import kenlm_trie as tkt
from vietasr_tpu_torch.ops import lm as tlm

WORD_CORPUS = ["ab cab ba", "ab ba", "cab ab ba c", "ba cab", "c ab",
               "ba ba cab", "c c ab ba"] * 2
VI_CORPUS = ["xin chào việt nam", "xin chào bạn", "việt nam quê hương",
             "chào việt nam", "xin cảm ơn bạn"] * 4
LABELS = list(" abcdefghijklmnopqrstuvwxyzàáâãèéêìíòóôõùúýăđĩũơưạảấầẩẫậắằẳẵ"
              "ặẹẻẽếềểễệỉịọỏốồổỗộớờởỡợụủứừửữựỳỵỷỹ")
# (writer kind, keyword arguments)
KINDS = [("probing", {}), ("trie", {}), ("quant_trie", {"quant_bits": (8, 8)}),
         ("quant_trie", {"quant_bits": (4, 4)})]


def _write(mod_binary, mod_trie, kind, arpa, path, kw):
    if kind == "probing":
        mod_binary.write_kenlm_binary(arpa, path, **kw)
    else:
        mod_trie.write_kenlm_trie(arpa, path, **kw)


@pytest.fixture(scope="module", params=[(WORD_CORPUS, 3), (VI_CORPUS, 3),
                                        (WORD_CORPUS, 5), (VI_CORPUS, 2)],
                ids=["word3", "vi3", "word5", "vi2"])
def arpa(request, tmp_path_factory):
    corpus, order = request.param
    p = tmp_path_factory.mktemp("arpa") / f"lm{order}.arpa"
    jlm.train_ngram_arpa(corpus, str(p), order=order)
    return str(p)


def _queries(lm, n=300, seed=0):
    rng = np.random.RandomState(seed)
    vocab = [w for w in lm.vocab if w not in ("<s>", "</s>", "<unk>")]
    out = []
    for _ in range(n):
        ctx = tuple(rng.choice(vocab + ["zz", "<s>"])
                    for _ in range(rng.randint(0, lm.order)))
        out.append((rng.choice(vocab + ["qq", "</s>"]), ctx))
    return out


def test_murmur64a_matches_jax():
    """The vocabulary hash: 0 for empty input (seed 0), and equal to the
    JAX package's on every tail length and on multi-byte UTF-8 words."""
    assert tkb.murmur64a(b"") == jkb.murmur64a(b"") == 0
    rng = np.random.RandomState(1)
    words = [b"a", b"ab", b"abcdefg", b"abcdefgh", b"abcdefghi", b"<unk>",
             "việt".encode(), "nguyễn".encode()]
    words += [bytes(rng.randint(0, 256, size=n).astype(np.uint8))
              for n in range(1, 40)]
    for w in words:
        for seed in (0, 1, 0xFFFFFFFFFFFFFFFF):
            h = tkb.murmur64a(w, seed)
            assert 0 <= h < 1 << 64
            assert h == jkb.murmur64a(w, seed), (w, seed)


@pytest.mark.parametrize("kind,kw", KINDS,
                         ids=["probing", "trie", "quant8", "quant4"])
def test_writers_byte_identical(arpa, tmp_path, kind, kw):
    a, b = str(tmp_path / "jax.binary"), str(tmp_path / "port.binary")
    _write(jkb, jkt, kind, arpa, a, kw)
    _write(tkb, tkt, kind, arpa, b, kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert tkb.is_kenlm_binary(b) and not tkb.is_kenlm_binary(arpa)
    assert not tkb.is_kenlm_binary(str(tmp_path / "missing"))


@pytest.mark.parametrize("kind,kw", KINDS,
                         ids=["probing", "trie", "quant8", "quant4"])
def test_readers_score_exactly_as_jax(arpa, tmp_path, kind, kw):
    path = str(tmp_path / "lm.binary")
    _write(tkb, tkt, kind, arpa, path, kw)
    got_lm, want_lm = tkb.read_kenlm_binary(path), \
        jkb.read_kenlm_binary(path)
    assert type(got_lm).__name__ == type(want_lm).__name__
    assert got_lm.order == want_lm.order
    for w, ctx in _queries(jlm.NGramLM(arpa)):
        assert got_lm.log_prob(w, ctx) == want_lm.log_prob(w, ctx), (w, ctx)
    words = [w for w in got_lm.vocab if w not in ("<s>", "</s>")][:6]
    assert got_lm.score_sentence(words) == want_lm.score_sentence(words)
    # the unquantized binaries also score as the ARPA does (f32 storage)
    if kind in ("probing", "trie"):
        ref = tlm.NGramLM(arpa)
        for w, ctx in _queries(ref, 50, seed=3):
            assert got_lm.log_prob(w, ctx) == pytest.approx(
                ref.log_prob(w, ctx), rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("kind,kw", KINDS[:3],
                         ids=["probing", "trie", "quant8"])
def test_to_ngram_lm_equals_jax(arpa, tmp_path, kind, kw):
    path = str(tmp_path / "lm.binary")
    _write(tkb, tkt, kind, arpa, path, kw)
    got = tkb.read_kenlm_binary(path).to_ngram_lm()
    want = jkb.read_kenlm_binary(path).to_ngram_lm()
    assert got.ngrams == want.ngrams
    assert got.vocab == want.vocab and got.order == want.order
    assert got.has_unk == want.has_unk
    if kind != "quant_trie":     # unquantized: the ARPA's n-grams exactly
        ref = tlm.NGramLM(arpa)
        assert set(got.ngrams) == set(ref.ngrams)


@pytest.mark.parametrize("kind,kw", KINDS[:3],
                         ids=["probing", "trie", "quant8"])
def test_load_lm_binary_device_tables_equal_jax(arpa, tmp_path, kind, kw):
    path = str(tmp_path / "lm.binary")
    _write(tkb, tkt, kind, arpa, path, kw)
    got_lm, want_lm = tlm.load_lm(path), jlm.load_lm(path)
    assert got_lm.ngrams == want_lm.ngrams
    (got, gp), (want, wp) = tlm.word_lm_tables(got_lm, LABELS), \
        jlm.word_lm_tables(want_lm, LABELS)
    assert gp == wp
    for name in ("packed", "masks", "bases", "unk_logp"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), name


def test_array_trie_and_bad_magic_raise(tmp_path):
    arpa = str(tmp_path / "lm.arpa")
    tlm.train_ngram_arpa(WORD_CORPUS, arpa, order=3)
    trie = str(tmp_path / "lm.trie")
    tkt.write_kenlm_trie(arpa, trie)
    data = bytearray(open(trie, "rb").read())
    data[96:100] = (4).to_bytes(4, "little")       # ARRAY_TRIE
    array_trie = tmp_path / "array.binary"
    array_trie.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="ARRAY|bhiksha"):
        tkb.read_kenlm_binary(str(array_trie))
    with pytest.raises(ValueError, match="ARRAY|bhiksha"):
        tlm.load_lm(str(array_trie))
    bad = tmp_path / "bad.binary"
    bad.write_bytes(b"mmap lm http://kheafield.com/code format version 4\n"
                    + bytes(200))
    with pytest.raises(ValueError, match="magic"):
        tkb.read_kenlm_binary(str(bad))
    with pytest.raises(ValueError, match="magic"):
        tkb.KenLMBinary(str(bad))


def test_bit_packing_matches_jax():
    rng = np.random.RandomState(7)
    widths = rng.randint(1, 58, size=200)
    values = [int(rng.randint(0, 1 << min(int(w), 62))) & ((1 << int(w)) - 1)
              for w in widths]
    writers = tkt._BitWriter(), jkt._BitWriter()
    for v, w in zip(values, widths):
        for bw in writers:
            bw.write(v, int(w))
    got, want = (bw.finish() for bw in writers)
    assert got == want
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int64)
    buf = np.frombuffer(got + bytes(8), np.uint8)
    for w in np.unique(widths):
        sel = widths == w
        read = tkt._read_bits_np(buf, offsets[sel], int(w))
        assert [int(x) for x in read] == [v for v, s in zip(values, sel) if s]
