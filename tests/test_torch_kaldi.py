"""The port's Kaldi ark / scp I/O (audio/kaldi.py) vs the JAX package's:
the writers byte for byte on the same seeded matrices, each package
reading the other's files to equal arrays, the refusals, and
KaldiFeatureDataset's items and drops."""

import struct

import numpy as np
import pytest

from vietasr_tpu.audio import kaldi as jax_kaldi
from vietasr_tpu.audio.tokenizer import CharTokenizer as JaxTokenizer
from vietasr_tpu_torch.audio import kaldi
from vietasr_tpu_torch.audio.tokenizer import CharTokenizer

LABELS = list(" abcdeghiklmnorstuvxyzàáạ")


def _records(seed, dims=13):
    rng = np.random.RandomState(seed)
    return {"utt1": rng.randn(17, dims).astype(np.float32),
            "utt2": (rng.rand(5, dims) * 10 - 5).astype(np.float32),
            "utt3": (rng.randn(64, dims) * 3 + 1).astype(np.float32),
            "one_row": rng.randn(1, dims).astype(np.float32)}


def _read_all(reader, path):
    return dict(reader(path))


@pytest.mark.parametrize("seed,dims", [(0, 13), (1, 64), (2, 1)])
def test_write_ark_bytes_equal_jax(tmp_path, seed, dims):
    recs = _records(seed, dims)
    paths = {}
    for who, mod in (("port", kaldi), ("jax", jax_kaldi)):
        d = tmp_path / who
        d.mkdir()
        # same file names, so the scp text (which holds the ark path) is
        # compared through its offsets
        mod.write_ark(str(d / "f.ark"), recs, str(d / "f.scp"))
        paths[who] = d
    assert (paths["port"] / "f.ark").read_bytes() \
        == (paths["jax"] / "f.ark").read_bytes()
    scp = [(paths[w] / "f.scp").read_text().replace(str(paths[w]), "D")
           for w in ("port", "jax")]
    assert scp[0] == scp[1]


@pytest.mark.parametrize("seed", [0, 3])
def test_write_compressed_ark_bytes_equal_jax(tmp_path, seed):
    recs = _records(seed)
    recs["const"] = np.full((4, 13), 2.5, np.float32)  # a zero range
    kaldi.write_compressed_ark(str(tmp_path / "p.ark"), recs)
    jax_kaldi.write_compressed_ark(str(tmp_path / "j.ark"), recs)
    assert (tmp_path / "p.ark").read_bytes() \
        == (tmp_path / "j.ark").read_bytes()


@pytest.mark.parametrize("compressed", [False, True])
def test_each_reads_the_others_files(tmp_path, compressed):
    recs = _records(4)
    writers = {"port": kaldi, "jax": jax_kaldi}
    for who, mod in writers.items():
        if compressed:
            mod.write_compressed_ark(str(tmp_path / f"{who}.ark"), recs)
        else:
            mod.write_ark(str(tmp_path / f"{who}.ark"), recs,
                          str(tmp_path / f"{who}.scp"))
    for who in writers:
        ark = str(tmp_path / f"{who}.ark")
        got = _read_all(kaldi.read_ark, ark)
        want = _read_all(jax_kaldi.read_ark, ark)
        assert list(got) == list(want) == list(recs)
        for k in recs:
            assert got[k].dtype == want[k].dtype == np.float32
            assert np.array_equal(got[k], want[k])
            if not compressed:
                assert np.array_equal(got[k], recs[k])
            else:
                scale = recs[k].max() - recs[k].min()
                assert np.abs(got[k] - recs[k]).max() < 0.02 * scale
        if not compressed:
            scp = str(tmp_path / f"{who}.scp")
            got_scp = _read_all(kaldi.read_scp, scp)
            want_scp = _read_all(jax_kaldi.read_scp, scp)
            for k in recs:
                assert np.array_equal(got_scp[k], want_scp[k])


def _dm_record(key, mat):
    out = key.encode() + b" \x00BDM "
    for dim in mat.shape:
        out += struct.pack("<b", 4) + struct.pack("<i", dim)
    return out + np.ascontiguousarray(mat, np.float64).tobytes()


def test_dm_reads_back_as_fp32(tmp_path):
    mat = np.random.RandomState(5).randn(6, 4)
    path = tmp_path / "dm.ark"
    path.write_bytes(_dm_record("d", mat))
    got = _read_all(kaldi.read_ark, str(path))["d"]
    want = _read_all(jax_kaldi.read_ark, str(path))["d"]
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got, mat.astype(np.float32))


@pytest.mark.parametrize("body,error", [
    (b"k [ 1 2 3 ]\n", ValueError),              # text format
    (b"k \x00BCM2 ", NotImplementedError),
    (b"k \x00BCM3 ", NotImplementedError),
    (b"k \x00BXX ", ValueError),                 # unknown matrix type
])
def test_refusals_match_jax(tmp_path, body, error):
    path = tmp_path / "bad.ark"
    path.write_bytes(body)
    for mod in (kaldi, jax_kaldi):
        with pytest.raises(error):
            _read_all(mod.read_ark, str(path))


@pytest.mark.parametrize("min_len,max_len", [(0, 0), (10, 0), (0, 20),
                                             (6, 40)])
def test_kaldi_feature_dataset_matches_jax(tmp_path, min_len, max_len):
    recs = _records(6, 8)
    recs["no_text"] = np.zeros((9, 8), np.float32)
    recs["bad_chars"] = np.ones((9, 8), np.float32)
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    kaldi.write_ark(ark, recs, scp)
    text = tmp_path / "text"
    text.write_text("utt1 xin chao\nutt2 khong ro\nutt3 cam on\n"
                    "one_row a\nbad_chars QQQ\n\n", encoding="utf-8")
    got = kaldi.KaldiFeatureDataset(scp, str(text), CharTokenizer(LABELS),
                                    min_len=min_len, max_len=max_len)
    want = jax_kaldi.KaldiFeatureDataset(scp, str(text),
                                         JaxTokenizer(LABELS),
                                         min_len=min_len, max_len=max_len)
    assert len(got) == len(want) and got.num_dropped == want.num_dropped
    assert got.num_dropped >= 2
    for i in range(len(got)):
        (ka, fa, ia), (kb, fb, ib) = got[i], want[i]
        assert ka == kb and ia == ib and np.array_equal(fa, fb)
