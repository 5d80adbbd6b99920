"""vietasr_tpu_torch.ops.beam_search and vietasr_tpu_torch.native against the
JAX package's host beam tier on the same seeded log-probs (numpy seeds, the
sizes of tests/test_beam_search.py and tests/test_native_beam.py).

Tolerances: none. The Python tiers run the same float arithmetic in the
same order, so texts, beam keys and beam totals are equal exactly; the C++
tiers are built from the same code, so their LM scores and texts are equal
exactly too.
"""

import os

import numpy as np
import pytest

from vietasr_tpu import native as jnative
from vietasr_tpu.ops import beam_search as jbs
from vietasr_tpu.ops import lm as jlm
from vietasr_tpu_torch import native as tnative
from vietasr_tpu_torch.ops import beam_search as tbs
from vietasr_tpu_torch.ops import kenlm_binary as tkb
from vietasr_tpu_torch.ops import kenlm_trie as tkt
from vietasr_tpu_torch.ops import lm as tlm

VI_CORPUS = ["xin chào việt nam", "xin chào bạn", "việt nam quê hương",
             "chào việt nam", "xin cảm ơn bạn"] * 4
VI_LABELS = [" ", "x", "i", "n", "c", "h", "à", "o", "v", "ệ", "t", "a", "m"]
ABC_LABELS = ["a", "b", "c", " "]
TINY_ARPA = """\
\\data\\
ngram 1=5
ngram 2=3

\\1-grams:
-1.0\t<s>\t-0.30103
-0.8\t</s>
-0.5\ta\t-0.2
-0.7\tb\t-0.1
-1.2\t<unk>

\\2-grams:
-0.3\t<s> a
-0.4\ta b
-0.9\tb </s>

\\end\\
"""


@pytest.fixture(scope="module")
def vi_arpa(tmp_path_factory):
    p = tmp_path_factory.mktemp("lm") / "vi.arpa"
    jlm.train_ngram_arpa(VI_CORPUS, str(p), order=3)
    return str(p)


@pytest.fixture(scope="module")
def vi_binaries(vi_arpa, tmp_path_factory):
    d = tmp_path_factory.mktemp("bin")
    probing, trie = str(d / "vi.probing.binary"), str(d / "vi.trie.binary")
    tkb.write_kenlm_binary(vi_arpa, probing)
    tkt.write_kenlm_trie(vi_arpa, trie)
    return {"probing": probing, "trie": trie}


def _log_probs(seed, t_max, v, scale=2.0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(t_max, v).astype(np.float32) * scale
    return np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))


def _beams(dec):
    return [(k, b.total()) for k, b in dec.beams.items()]


# (seed, labels, T, beam width, LM, alpha, beta): test_native_beam.py's
# no-LM and word 3-gram cases, test_beam_search.py's exhaustive cases
CASES = ([(s, "abc", 20, 30, None, 0.5, 1.5) for s in range(6)]
         + [(100 + s, "vi", 15, 25, "vi", 0.7, 1.0) for s in range(4)]
         + [(s, "ab", 5, 200, None, 0.5, 1.5) for s in range(3)]
         + [(s, "ab", 5, 400, "tiny", 0.8, 0.5) for s in (3, 4)])


def _case(case, vi_arpa, tmp_path):
    seed, kind, t_max, width, lm_kind, alpha, beta = case
    labels = {"abc": ABC_LABELS, "vi": VI_LABELS,
              "ab": ["a", "b", " "]}[kind]
    lp = _log_probs(seed, t_max, len(labels) + 1,
                    scale=1.5 if lm_kind == "tiny" else 2.0)
    path = None
    if lm_kind == "vi":
        path = vi_arpa
    elif lm_kind == "tiny":
        path = str(tmp_path / "tiny.arpa")
        with open(path, "w") as f:
            f.write(TINY_ARPA)
    kw = dict(beam_width=width, alpha=alpha, beta=beta, token_min_logp=-50.0)
    return labels, lp, path, kw


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}{c[0]}-{c[4]}")
def test_prefix_beam_search_equals_jax(case, vi_arpa, tmp_path):
    labels, lp, path, kw = _case(case, vi_arpa, tmp_path)
    t_lm = tlm.NGramLM(path) if path else None
    j_lm = jlm.NGramLM(path) if path else None
    got = tbs.prefix_beam_search(lp, labels, lm=t_lm, **kw)
    assert got == jbs.prefix_beam_search(lp, labels, lm=j_lm, **kw)
    # the whole beam after every frame: the same keys, the same totals
    t_dec = tbs.StreamingPrefixBeam(labels, lm=t_lm, **kw)
    j_dec = jbs.StreamingPrefixBeam(labels, lm=j_lm, **kw)
    t_dec.feed(lp)
    j_dec.feed(lp)
    assert _beams(t_dec) == _beams(j_dec)


@pytest.mark.parametrize("case", CASES[::2], ids=lambda c: f"{c[1]}{c[0]}")
def test_streaming_chunks_equal_jax(case, vi_arpa, tmp_path):
    labels, lp, path, kw = _case(case, vi_arpa, tmp_path)
    t_dec = tbs.StreamingPrefixBeam(
        labels, lm=tlm.NGramLM(path) if path else None, **kw)
    j_dec = jbs.StreamingPrefixBeam(
        labels, lm=jlm.NGramLM(path) if path else None, **kw)
    cuts = sorted({0, 1, 4, len(lp) // 2, len(lp)})
    for a, b in zip(cuts[:-1], cuts[1:]):
        t_dec.feed(lp[a:b])
        j_dec.feed(lp[a:b])
        assert t_dec.best() == j_dec.best()
        assert _beams(t_dec) == _beams(j_dec)
    assert t_dec.best() == tbs.prefix_beam_search(
        lp, labels, lm=t_dec.lm, **kw)


def test_native_lm_equals_jax(vi_arpa):
    got, want = tnative.NativeLM(vi_arpa), jnative.NativeLM(vi_arpa)
    py = tlm.NGramLM(vi_arpa)
    assert got.order == want.order == 3
    cases = [("chào", ("xin",)), ("việt", ("xin", "chào")),
             ("nam", ("việt",)), ("zzz", ("xin",)), ("xin", ()),
             ("quê", ("chào", "việt"))]
    for w, ctx in cases:
        assert got.log_prob(w, ctx) == want.log_prob(w, ctx), (w, ctx)
        assert abs(got.log_prob(w, ctx) - py.log_prob(w, ctx)) < 1e-4


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}{c[0]}-{c[4]}")
def test_native_decode_equals_jax_and_python(case, vi_arpa, tmp_path):
    """The C++ tier against JAX's C++ tier at the reference's pruning, and
    against the Python tier with the pruning off (as test_native_beam.py
    holds JAX's)."""
    labels, lp, path, kw = _case(case, vi_arpa, tmp_path)
    width = kw.pop("beam_width")
    for extra in ({}, {"cutoff_top_n": 0, "beam_prune_logp": -1e9}):
        got = tnative.CtcBeamNative(labels, lm_path=path, **kw, **extra)
        want = jnative.CtcBeamNative(labels, lm_path=path, **kw, **extra)
        assert got.decode(lp, width) == want.decode(lp, width)
    assert got.decode(lp, width) == tbs.prefix_beam_search(
        lp, labels, beam_width=width,
        lm=tlm.NGramLM(path) if path else None, **kw)


def test_native_utf8_output(vi_arpa):
    labels = [" ", "v", "i", "ệ", "t"]
    lp = np.full((6, 6), -9.0, np.float32)
    for t, c in enumerate([1, 2, 3, 4, 5, 5]):     # v i ệ t blank blank
        lp[t, c] = -0.01
    dec = tnative.CtcBeamNative(labels, lm_path=vi_arpa)
    assert dec.decode(lp, beam_width=8) == "việt"


def _batch(seed, labels, bsz=6, t_max=40):
    rng = np.random.RandomState(seed)
    logits = rng.randn(bsz, t_max, len(labels) + 1).astype(np.float32) * 3
    logits[..., -1] += 1.0                          # blank-heavy, as CTC
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = rng.randint(0, t_max + 1, size=bsz).astype(np.int32)
    lens[0] = t_max
    return lp.astype(np.float32), lens


@pytest.mark.parametrize("lm_kind", [None, "arpa", "probing", "trie"])
def test_decode_batch_native_equals_python_and_jax(lm_kind, vi_arpa,
                                                   vi_binaries):
    path = {None: None, "arpa": vi_arpa}.get(lm_kind) \
        or vi_binaries.get(lm_kind)
    lp, lens = _batch(5, VI_LABELS)
    kw = dict(lm_path=path, alpha=0.5, beta=1.5, beam_width=16)
    native = tbs.BeamSearchDecoderLM(VI_LABELS, **kw)
    python = tbs.BeamSearchDecoderLM(VI_LABELS, use_native=False, **kw)
    assert native._native is not None and python._native is None
    texts = native.decode_batch(lp, lens)
    assert texts == python.decode_batch(lp, lens)
    assert texts == jbs.BeamSearchDecoderLM(VI_LABELS, **kw).decode_batch(
        lp, lens)
    if lm_kind in ("probing", "trie"):
        # a binary decodes as its ARPA does
        arpa = tbs.BeamSearchDecoderLM(VI_LABELS, **{**kw,
                                                     "lm_path": vi_arpa})
        assert texts == arpa.decode_batch(lp, lens)


def test_binary_spill_is_deleted(vi_binaries, monkeypatch, tmp_path):
    """The ARPA spilled for the C++ LM goes once the LM has read it; the
    decoder still decodes from the LM it loaded."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    dec = tbs.BeamSearchDecoderLM(VI_LABELS, lm_path=vi_binaries["probing"],
                                  beam_width=8)
    assert os.listdir(tmp_path) == []
    lp, lens = _batch(6, VI_LABELS, bsz=2)
    assert dec.decode_batch(lp, lens) == tbs.BeamSearchDecoderLM(
        VI_LABELS, lm_path=vi_binaries["probing"], beam_width=8,
        use_native=False).decode_batch(lp, lens)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile raises from the
    build, from CtcBeamNative and from BeamSearchDecoderLM; the Python
    tier is there only when asked for."""
    broken = tmp_path / "ctc_beam.cc"
    broken.write_text("this is not C++ {\n")
    monkeypatch.setattr(tnative, "_SRC", str(broken))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native beam build failed"):
        tnative.build_native()
    with pytest.raises(RuntimeError, match="native beam build failed"):
        tnative.CtcBeamNative(VI_LABELS)
    with pytest.raises(RuntimeError, match="native beam build failed"):
        tbs.BeamSearchDecoderLM(VI_LABELS)
    assert os.listdir(tnative.BUILD_DIR) == []      # no half-built file
    lp, lens = _batch(7, VI_LABELS, bsz=2)
    assert len(tbs.BeamSearchDecoderLM(
        VI_LABELS, use_native=False).decode_batch(lp, lens)) == 2


def test_native_library_is_the_ports_own():
    """The port builds its own library from its own source, into its own
    build directory, keyed on the source's hash."""
    path = tnative.build_native()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.path.basename(path).startswith("ctcbeam-")
    assert tnative._SRC.startswith(os.path.dirname(tnative.__file__))
    assert "vietasr_tpu_torch" in path and "libctcbeam" not in path


def test_decode_rejects_wrong_width():
    from vietasr_tpu_torch.utils.typing import ContractError

    dec = tbs.BeamSearchDecoderLM(VI_LABELS, use_native=False)
    with pytest.raises(ContractError):
        dec.decode(np.zeros((4, len(VI_LABELS)), np.float32))
    assert dec.decode(np.zeros((0, len(VI_LABELS) + 1), np.float32)) == ""
