"""vietasr_tpu_torch Transcriber vs the JAX package's, at the full width
of QuartzNet12x1_vi on the trained anchor weights, on the CPU.

Three seeded clips in two duration buckets go through both in fp32: log
probabilities within 1e-4 (fp32 sums in another order over 15 blocks;
measured ~3e-5), encoded lengths and transcripts equal.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from vietasr_tpu.pipeline import Transcriber as JaxTranscriber
from vietasr_tpu.pipeline import TranscriberOptions as JaxOptions
from vietasr_tpu_torch.models.convert import load_anchor
from vietasr_tpu_torch.pipeline import Transcriber, TranscriberOptions

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vietasr_tpu_torch", "configs",
                      "quartznet12x1_vi.yaml")
ANCHOR = os.path.join(ROOT, "artifacts", "real_speech_qn12x1_vi.msgpack.gz")


@pytest.fixture(scope="module")
def anchor():
    return load_anchor(ANCHOR)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.RandomState(0)
    # 1.5 s and 1.9 s share the 2 s bucket; 3.1 s goes to the 4 s bucket
    return [(rng.randn(n) * 0.1).astype(np.float32)
            for n in (24000, 30400, 49600)]


@pytest.fixture(scope="module")
def pair(anchor):
    jax_tr = JaxTranscriber(CONFIG, variables=anchor,
                            options=JaxOptions(compute_dtype=None))
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(compute_dtype=None))
    return jax_tr, port


def test_load_anchor_matches_flax(anchor):
    import flax.serialization

    with gzip.open(ANCHOR, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())

    def check(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys()
            for k in b:
                check(a[k], b[k])
        elif isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b)
            for x, y in zip(a, b):
                check(x, y)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    check(anchor, want)


def test_transcripts_equal_jax(pair, clips):
    jax_tr, port = pair
    want = jax_tr.transcribe_batch(clips)
    got = port.transcribe_batch(clips)
    assert got == want
    assert all(isinstance(t, str) for t in got)


def test_log_probs_match_jax(pair, clips):
    jax_tr, port = pair
    for clip in clips:
        want, want_lens = jax_tr.log_probs(clip)
        got, got_lens = port.log_probs(clip)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got_lens, want_lens)
        assert np.abs(got - want).max() <= 1e-4


def test_batched_rows_match_single(pair, clips):
    """Batching a short clip beside a long one leaves the long one's
    log-probs as they are alone (masking)."""
    _, port = pair
    long, short = clips[1], clips[0]
    batch = np.zeros((2, len(long)), np.float32)
    batch[0], batch[1, :len(short)] = long, short
    lp, lens = port.log_probs(batch, lengths=[len(long), len(short)])
    alone, alone_lens = port.log_probs(long)
    assert lens[0] == alone_lens[0]
    assert np.abs(lp[0, :lens[0]] - alone[0, :lens[0]]).max() <= 1e-4


def test_bf16_kernel_route_runs(anchor, pair, clips):
    """The default bf16 options (kernel route; its plain version on the
    CPU) stay near fp32: measured max |d log p| ~0.11 over 15 blocks of
    bf16 operands, bound 0.5; lengths equal."""
    _, port32 = pair
    port = Transcriber(CONFIG, variables=anchor, device="cpu",
                       options=TranscriberOptions(fused_frontend="on"))
    for clip in clips:
        lp, lens = port.log_probs(clip)
        ref, ref_lens = port32.log_probs(clip)
        assert np.isfinite(lp).all()
        np.testing.assert_array_equal(lens, ref_lens)
        assert np.abs(lp - ref).max() <= 0.5


def test_options_not_ported_raise(anchor):
    for opts, err in ((TranscriberOptions(decoder="beam"),
                       NotImplementedError),
                      (TranscriberOptions(decoder="device_beam"),
                       NotImplementedError),
                      (TranscriberOptions(lm_path="lm.arpa"),
                       NotImplementedError),
                      (TranscriberOptions(fused_frontend="fast"), ValueError),
                      (TranscriberOptions(block_impl="pallas"), ValueError)):
        with pytest.raises(err):
            Transcriber(CONFIG, variables=anchor, device="cpu", options=opts)
    with pytest.raises(ValueError):
        Transcriber(CONFIG, device="cpu")


def test_default_device_is_cuda(anchor):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Transcriber(CONFIG, variables=anchor)
