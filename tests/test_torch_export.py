"""vietasr_tpu_torch/export.py (torch.export) and the kernels' custom ops
(ops/custom_ops.py) against the JAX package's export (StableHLO) and the
port's eager Transcriber, on the CPU, on the anchor's weights.

Tolerances: the loaded program against the eager Transcriber it was
exported from, exact (the same ops on the same inputs); against JAX's
loaded StableHLO, 1e-4 in log p (JAX's own export bar,
tests/test_extras.py::test_stablehlo_export_roundtrip), ids and lengths
exact.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vietasr_tpu.export import export_transcriber as jax_export
from vietasr_tpu.export import load_exported as jax_load
from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch.export import export_transcriber, load_exported
from vietasr_tpu_torch.config import load_config
from vietasr_tpu_torch.frontend.features import (_mel_matrix,
                                                 _windowed_dft_matrix,
                                                 preemphasize_and_pad)
from vietasr_tpu_torch.models.convert import load_anchor
from vietasr_tpu_torch.ops import custom_ops
from vietasr_tpu_torch.ops.device_beam import init_packed_state
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")
OUTPUTS = ("log_probs", "enc_lens", "greedy_preds", "keep_mask")


@pytest.fixture(scope="module")
def anchor():
    return load_anchor(ANCHOR)


def _signal(seed, n):
    return (np.random.RandomState(seed).randn(1, n) * 0.1).astype(np.float32)


def test_manifest_and_outputs_match_jax(tmp_path, anchor):
    """JAX's export_transcriber and the port's at buckets_seconds=(1.0,),
    fp32: the manifests hold the same fields (the file extension aside),
    and the loaded programs' four outputs agree."""
    jtr = JaxTranscriber(CONFIG, variables=anchor, options=JaxOptions(
        buckets_seconds=(1.0,), compute_dtype=None))
    want_manifest = jax_export(jtr, str(tmp_path / "jax"), batch_sizes=(1,))
    tr = Transcriber(CONFIG, variables=anchor, device="cpu",
                     options=TranscriberOptions(buckets_seconds=(1.0,),
                                                compute_dtype=None))
    out = str(tmp_path / "port")
    manifest = export_transcriber(tr, out, batch_sizes=(1,))
    with open(os.path.join(out, "manifest.json"), encoding="utf-8") as f:
        assert json.load(f) == manifest
    for entry in want_manifest["functions"]:
        entry["file"] = entry["file"].replace(".stablehlo", ".pt2")
    assert manifest == want_manifest
    assert manifest["blank_id"] == 90 and list(manifest["outputs"]) \
        == list(OUTPUTS)

    f = manifest["functions"][0]
    sig = _signal(0, f["samples"])
    lens = np.array([f["samples"]], np.int32)
    got = load_exported(os.path.join(out, f["file"]))(
        torch.from_numpy(sig), torch.from_numpy(lens))
    want = jax_load(os.path.join(str(tmp_path / "jax"), f["file"].replace(
        ".pt2", ".stablehlo")))(jnp.asarray(sig), jnp.asarray(lens))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("opts", [
    dict(compute_dtype=None),
    dict(compute_dtype="bfloat16", fused_frontend="on"),
    dict(compute_dtype="bfloat16", fused_frontend="fast"),
], ids=["fp32", "bf16-kernels", "bf16-fast"])
def test_loaded_program_equals_the_transcriber(tmp_path, anchor, opts):
    """Two shapes each; the bf16 routes take the frontend op once and the
    repeat op 13 times a forward (the program's own graph), and the
    loaded program's outputs equal the eager forward's bit for bit on
    rows of several lengths."""
    tr = Transcriber(CONFIG, variables=anchor, device="cpu",
                     options=TranscriberOptions(buckets_seconds=(1.0, 2.0),
                                                **opts))
    manifest = export_transcriber(tr, str(tmp_path), batch_sizes=(3,),
                                  buckets=[16000, 24000])
    assert [(f["batch"], f["samples"]) for f in manifest["functions"]] \
        == [(3, 16000), (3, 24000)]
    for f in manifest["functions"]:
        path = os.path.join(str(tmp_path), f["file"])
        program = torch.export.load(path)
        targets = [str(n.target) for n in program.graph.nodes
                   if "vietasr" in str(n.target)]
        if opts["compute_dtype"] is None:
            assert targets == []
        else:
            assert targets.count("vietasr.log_mel_tiles.default") == 1
            assert targets.count("vietasr.repeat_block.default") == 13
        n = f["samples"]
        sig = torch.from_numpy(np.concatenate(
            [_signal(s, n) for s in (1, 2, 3)]))
        lens = torch.tensor([n, n // 2, 1000], dtype=torch.int32)
        got = load_exported(path)(sig, lens)
        with torch.inference_mode():
            want = tr._forward(sig, lens)
        for name, g, w in zip(OUTPUTS, got, want):
            assert torch.equal(g, w), name


def _op_cases():
    """(name, op, args) of each custom op on small CPU inputs."""
    tr_cfg = load_config(CONFIG).featurizer
    cfg_json = json.dumps(dataclasses.asdict(tr_cfg))
    rng = np.random.RandomState(4)
    sig = torch.from_numpy((rng.randn(2, 8000) * 0.1).astype(np.float32))
    xp = preemphasize_and_pad(sig, tr_cfg).contiguous()
    seq = torch.tensor([50, 31], dtype=torch.int32)
    dft = torch.as_tensor(_windowed_dft_matrix(tr_cfg))
    mel = torch.as_tensor(_mel_matrix(tr_cfg))
    x = torch.from_numpy(rng.randn(2, 40, 32).astype(np.float32)) \
        .to(torch.bfloat16)
    lens = torch.tensor([40, 17], dtype=torch.int32)
    dw = [torch.from_numpy(rng.randn(5, 32).astype(np.float32))]
    pw = [torch.from_numpy(rng.randn(32, 32).astype(np.float32) * 0.1)
          .to(torch.bfloat16)]
    b = [torch.from_numpy(rng.randn(32).astype(np.float32))]
    res_w = torch.from_numpy(rng.randn(32, 32).astype(np.float32) * 0.1) \
        .to(torch.bfloat16)
    lp = torch.log_softmax(torch.from_numpy(
        rng.randn(2, 12, 6).astype(np.float32)), -1)
    state = init_packed_state(2, 4, None, "cpu")
    return [
        ("log_mel_tiles/highest", torch.ops.vietasr.log_mel_tiles.default,
         (xp, seq, [dft, mel], [], cfg_json, "highest")),
        ("log_mel_tiles/default", torch.ops.vietasr.log_mel_tiles.default,
         (xp, seq, [dft, mel], [], cfg_json, "default")),
        ("repeat_block/res", torch.ops.vietasr.repeat_block.default,
         (x, lens, dw, pw, b, res_w, b[0], 5, False)),
        ("repeat_block/plain", torch.ops.vietasr.repeat_block.default,
         (x, lens, dw, pw, b, None, None, 5, True)),
        ("beam_search", torch.ops.vietasr.beam_search.default,
         (lp, torch.tensor([12, 7], dtype=torch.int32), state, [], 5, 0,
          0.5, 0.0, 3, 8)),
    ]


CASES = _op_cases()


@pytest.mark.parametrize("name,op,args", CASES, ids=[c[0] for c in CASES])
def test_custom_op_fake_shapes_and_opcheck(name, op, args):
    """Each op's fake implementation gives its real outputs' shapes and
    dtypes, and torch.library.opcheck passes (schema, fake tensor,
    autograd registration, AOT dispatch)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    real = op(*args)
    real = real if isinstance(real, tuple) else (real,)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else
                     [mode.from_tensor(t) for t in a]
                     if isinstance(a, list) and a and torch.is_tensor(a[0])
                     else a for a in args]
        fake = op(*fake_args)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype) for t in fake] \
        == [(t.shape, t.dtype) for t in real]
    torch.library.opcheck(op, args)


def test_wrappers_take_the_ops_only_inside_through_ops():
    """Eager calls go straight to the launches (no op dispatch on the
    host-bound path); through_ops() routes them through the ops, with the
    same result."""
    from vietasr_tpu_torch.ops.repeat_block import fused_repeat_block

    assert custom_ops.active() is False
    name, op, args = CASES[2]
    direct = fused_repeat_block(*args[:7], kernel=5)
    with custom_ops.through_ops():
        assert custom_ops.active()
        via = fused_repeat_block(*args[:7], kernel=5)
    assert not custom_ops.active()
    assert torch.equal(direct, via)
