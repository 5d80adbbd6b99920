"""vietasr_tpu_torch.models.convert's NeMo `.pt` converters against the JAX
package's, on state dicts written from the trained anchor
(QuartzNet12x1_vi, 5,109,147 params) in the reference's key layout:
every leaf equal bit for bit (np.array_equal), both ways."""

import os

import numpy as np
import pytest
import torch

from vietasr_tpu.models import convert as jconvert
from vietasr_tpu_torch.config import load_config
from vietasr_tpu_torch.models import convert as tconvert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")


def _pairs(a, b, path=""):
    """[(path, leaf of a, leaf of b)], asserting the same structure."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        return [p for k in a for p in _pairs(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _pairs(x, y, f"{path}[{i}]")]
    return [(path, a, b)]


def save_pt(sd, path, prefix):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items() if k.startswith(prefix)}, path)


@pytest.fixture(scope="module")
def cfg():
    return load_config(CONFIG)


@pytest.fixture(scope="module")
def anchor():
    return tconvert.load_anchor(ANCHOR)


@pytest.fixture(scope="module")
def pt_files(anchor, cfg, tmp_path_factory):
    """The anchor as the reference's two checkpoint files, written from the
    JAX package's exporter."""
    d = tmp_path_factory.mktemp("pt")
    sd = jconvert.state_dict_from_variables(anchor, cfg.encoder)
    enc, dec = str(d / "JasperEncoder-STEP-0.pt"), \
        str(d / "JasperDecoderForCTC-STEP-0.pt")
    save_pt(sd, enc, "encoder.")
    save_pt(sd, dec, "decoder_layers.")
    return enc, dec


def test_state_dict_from_variables_equals_jax(anchor, cfg):
    got = tconvert.state_dict_from_variables(anchor, cfg.encoder)
    want = jconvert.state_dict_from_variables(anchor, cfg.encoder)
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert np.array_equal(got[k], w), k
    # tensors in, the same arrays out
    on_torch = tconvert.params_from_jax(anchor, device="cpu")
    again = tconvert.state_dict_from_variables(on_torch, cfg.encoder)
    assert all(np.array_equal(again[k], got[k]) for k in got)


def test_variables_from_checkpoints_equals_jax(pt_files, anchor, cfg):
    got = tconvert.variables_from_checkpoints(*pt_files, cfg.encoder)
    want = jconvert.variables_from_checkpoints(*pt_files, cfg.encoder)
    pairs = _pairs(got, want)
    assert len(pairs) == len(_pairs(anchor, anchor))
    for path, g, w in pairs:
        w = np.asarray(w)
        assert isinstance(g, np.ndarray), path
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.array_equal(g, w), path
    # the round trip returns the anchor
    for path, g, a in _pairs(got, anchor):
        assert np.array_equal(g, np.asarray(a)), path
    n = sum(np.asarray(a).size for _, a, _ in _pairs(anchor["params"],
                                                    anchor["params"]))
    assert n == 5_109_147


def test_load_torch_state_dict_equals_jax(pt_files):
    for path in pt_files:
        got = tconvert.load_torch_state_dict(path)
        want = jconvert.load_torch_state_dict(path)
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_encoder_and_decoder_from_state_dict(pt_files, cfg):
    enc_sd = tconvert.load_torch_state_dict(pt_files[0])
    dec_sd = tconvert.load_torch_state_dict(pt_files[1])
    got = tconvert.encoder_from_state_dict(enc_sd, cfg.encoder)
    want = jconvert.encoder_from_state_dict(enc_sd, cfg.encoder)
    for path, g, w in _pairs(got, want):
        assert np.array_equal(g, np.asarray(w)), path
    got = tconvert.decoder_from_state_dict(dec_sd)
    want = jconvert.decoder_from_state_dict(dec_sd)
    assert got["w"].shape == (cfg.encoder.blocks[-1].filters,
                              cfg.num_classes + 1)
    for path, g, w in _pairs(got, want):
        assert np.array_equal(g, np.asarray(w)), path


def test_depthwise_kernel_must_be_effective_kernel(pt_files, cfg):
    """A checkpoint whose depthwise kernel is not the config's
    effective_kernel raises rather than convolving with the wrong rows."""
    sd = dict(tconvert.load_torch_state_dict(pt_files[0]))
    key = "encoder.1.mconv.0.conv.weight"
    sd[key] = sd[key][:, :, 1:-1]
    with pytest.raises(ValueError, match="effective_kernel"):
        tconvert.encoder_from_state_dict(sd, cfg.encoder)


def test_pt_file_runs_no_code(tmp_path):
    """weights_only: a pickle that would run code on load is refused."""
    class Evil:
        def __reduce__(self):
            return (os.getcwd, ())

    path = str(tmp_path / "evil.pt")
    torch.save({"x": Evil()}, path)
    with pytest.raises(Exception):
        tconvert.load_torch_state_dict(path)
