"""The port's losses (ops/losses.py), classification head
(models/classifier.py) and label / transcript datasets
(audio/dataset.py) vs the JAX package's, on seeded numpy inputs and on
WAVs written into tmp_path."""

import random

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from vietasr_tpu.audio import dataset as jax_ds
from vietasr_tpu.audio.augment import AudioAugmentor as JaxAugmentor
from vietasr_tpu.audio.augment import GainPerturbation as JaxGain
from vietasr_tpu.audio.manifest import ManifestEntry as JaxEntry
from vietasr_tpu.audio.tokenizer import CharTokenizer as JaxTokenizer
from vietasr_tpu.models import classifier as jax_cls
from vietasr_tpu.ops import losses as jax_losses
from vietasr_tpu_torch.audio import dataset
from vietasr_tpu_torch.audio.augment import AudioAugmentor, GainPerturbation
from vietasr_tpu_torch.audio.manifest import ManifestEntry
from vietasr_tpu_torch.audio.tokenizer import CharTokenizer
from vietasr_tpu_torch.models import classifier
from vietasr_tpu_torch.ops import losses

RTOL = 1e-6       # fp32, the same formulas


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# losses


@pytest.mark.parametrize("weighted", [False, True, "zero"])
def test_cross_entropy_matches_jax(weighted):
    rng = np.random.RandomState(0)
    logits = (rng.randn(7, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, size=7).astype(np.int32)
    weights = None
    if weighted:
        weights = rng.rand(7).astype(np.float32)
        if weighted == "zero":
            weights[:] = 0.0      # the denominator max(sum(w), 1e-9)
    want = jax_losses.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        weights=None if weights is None else jnp.asarray(weights))
    x = _t(logits).requires_grad_()
    got = losses.cross_entropy_loss(
        x, _t(labels), weights=None if weights is None else _t(weights))
    _close(got, want)
    got.backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    if weighted != "zero":
        assert float(x.grad.abs().sum()) > 0


def test_cross_entropy_matches_torch():
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 5).astype(np.float32)
    labels = rng.randint(0, 5, size=6)
    got = losses.cross_entropy_loss(_t(logits), _t(labels))
    want = torch.nn.functional.cross_entropy(_t(logits), _t(labels))
    assert abs(float(got) - float(want)) < 1e-6


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("pad_id", [0, 3])
def test_sequence_loss_matches_jax(smoothing, pad_id):
    rng = np.random.RandomState(2)
    b, t, v = 4, 9, 6
    logits = rng.randn(b, t, v).astype(np.float32)
    lp = np.asarray(torch.log_softmax(_t(logits), -1))
    targets = rng.randint(0, v, size=(b, t)).astype(np.int32)
    lengths = np.array([9, 5, 1, 0], np.int32)
    want = jax_losses.sequence_loss(jnp.asarray(lp), jnp.asarray(targets),
                                    jnp.asarray(lengths), pad_id=pad_id,
                                    smoothing=smoothing)
    x = _t(lp).requires_grad_()
    got = losses.sequence_loss(x, _t(targets), _t(lengths), pad_id=pad_id,
                               smoothing=smoothing)
    _close(got, want)
    got.backward()
    # no gradient reaches positions past a row's length
    assert float(x.grad[3].abs().sum()) == 0.0
    assert float(x.grad[0].abs().sum()) > 0.0


def test_sequence_loss_with_no_valid_position():
    lp = torch.log_softmax(torch.randn(2, 3, 4,
                                       generator=torch.Generator()
                                       .manual_seed(0)), -1)
    got = losses.sequence_loss(lp, torch.zeros(2, 3, dtype=torch.int32),
                               torch.tensor([3, 3]), pad_id=0)
    want = jax_losses.sequence_loss(jnp.asarray(lp.numpy()),
                                    jnp.zeros((2, 3), jnp.int32),
                                    jnp.asarray([3, 3]), pad_id=0)
    assert float(got) == float(want) == 0.0


def test_mse_and_aggregate_match_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(5, 4).astype(np.float32), rng.randn(5, 4).astype(
        np.float32)
    x = _t(a).requires_grad_()
    m = losses.mse_loss(x, _t(b))
    _close(m, jax_losses.mse_loss(jnp.asarray(a), jnp.asarray(b)))
    parts = [m, losses.mse_loss(_t(b), _t(a) * 2)]
    want_parts = [jax_losses.mse_loss(jnp.asarray(a), jnp.asarray(b)),
                  jax_losses.mse_loss(jnp.asarray(b), jnp.asarray(a) * 2)]
    for w in (None, [0.25, 2.0]):
        _close(losses.aggregate_losses(parts, w),
               jax_losses.aggregate_losses(want_parts, w))
    losses.aggregate_losses(parts, [0.5, 1.0]).backward()
    assert float(x.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# classification head


def _head(feat_in, num_classes, seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(feat_in, num_classes).astype(np.float32) * 0.3,
            "b": rng.randn(num_classes).astype(np.float32) * 0.1}


@pytest.mark.parametrize("pooling", ["avg", "max"])
@pytest.mark.parametrize("return_logits", [True, False])
def test_classifier_apply_matches_jax(pooling, return_logits):
    rng = np.random.RandomState(4)
    head = _head(16, 7, 5)
    enc = rng.randn(5, 13, 16).astype(np.float32)
    lens = np.array([13, 6, 1, 12, 3], np.int32)
    want = jax_cls.classifier_apply(
        {k: jnp.asarray(v) for k, v in head.items()}, jnp.asarray(enc),
        jnp.asarray(lens), pooling=pooling, return_logits=return_logits)
    got = classifier.classifier_apply(
        {k: _t(v) for k, v in head.items()}, _t(enc), _t(lens),
        pooling=pooling, return_logits=return_logits)
    _close(got, want, rtol=1e-6, atol=1e-6)


def test_classifier_padding_does_not_reach_the_pool():
    head = {k: _t(v) for k, v in _head(8, 3, 6).items()}
    enc = torch.randn(2, 10, 8, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([10, 4])
    for pooling in ("avg", "max"):
        a = classifier.classifier_apply(head, enc, lens, pooling=pooling)
        noisy = enc.clone()
        noisy[1, 4:] = 1e3
        b = classifier.classifier_apply(head, noisy, lens, pooling=pooling)
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        classifier.classifier_apply(head, enc, lens, pooling="median")


def test_init_classifier_head_shapes_and_bounds():
    head = classifier.init_classifier_head(torch.Generator().manual_seed(0),
                                           1024, 35, device="cpu")
    assert head["w"].shape == (1024, 35) and head["b"].shape == (35,)
    assert float(head["w"].abs().max()) <= (6 / (1024 + 35)) ** 0.5
    assert float(head["b"].abs().max()) <= 1024 ** -0.5
    jax_head = jax_cls.init_classifier_head(
        __import__("jax").random.PRNGKey(0), 1024, 35)
    assert {k: tuple(v.shape) for k, v in jax_head.items()} \
        == {k: tuple(v.shape) for k, v in head.items()}


@pytest.mark.parametrize("case", ["random", "ties", "all_equal"])
def test_classification_accuracy_matches_jax(case):
    rng = np.random.RandomState(7)
    logits = rng.randn(32, 10).astype(np.float32)
    if case == "ties":
        logits = np.round(logits * 2) / 2           # many equal logits
    elif case == "all_equal":
        logits = np.zeros_like(logits)
    targets = rng.randint(0, 10, size=32).astype(np.int32)
    top_k = (1, 2, 3, 5)
    want = jax_cls.classification_accuracy(jnp.asarray(logits),
                                           jnp.asarray(targets), top_k)
    got = classifier.classification_accuracy(_t(logits), _t(targets), top_k)
    assert got == want
    if case == "all_equal":
        # the higher index ranks first among ties, as in JAX
        assert got[0] == float(np.mean(targets == 9))


# ---------------------------------------------------------------------------
# label and transcript datasets

COMMANDS = ["yes", "no", "up", "down", "left"]


def _label_corpus(tmp_path, n=8):
    rng = np.random.RandomState(11)
    entries = []
    names = COMMANDS + ["unknown_word"]
    for i in range(n):
        x = (rng.randn(int(16000 * (0.5 + 0.1 * i))) * 3000).clip(
            -32768, 32767).astype(np.int16)
        x[:800] = 0                                  # silence to trim
        path = str(tmp_path / f"c{i}.wav")
        wavfile.write(path, 16000, x)
        label = names[i % len(names)]
        entries.append((path, len(x) / 16000, f" {label} "))
    return entries


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("augment", [False, True])
def test_audio_label_dataset_matches_jax(tmp_path, trim, augment):
    raw = _label_corpus(tmp_path)
    port_aug = jax_aug = None
    if augment:
        port_aug = AudioAugmentor(
            [(1.0, GainPerturbation(rng=random.Random(6)))],
            rng=random.Random(5))
        jax_aug = JaxAugmentor([(1.0, JaxGain(rng=random.Random(6)))],
                               rng=random.Random(5))
    got = dataset.AudioLabelDataset(
        [ManifestEntry(p, d, t) for p, d, t in raw], COMMANDS, trim=trim,
        augmentor=port_aug)
    want = jax_ds.AudioLabelDataset(
        [JaxEntry(p, d, t) for p, d, t in raw], COMMANDS, trim=trim,
        augmentor=jax_aug)
    assert len(got) == len(want) == 7
    assert got.num_dropped == want.num_dropped == 1
    assert got.label_ids == want.label_ids
    assert got.label2id == want.label2id
    for i in range(len(got)):
        (a, la), (b, lb) = got[i], want[i]
        assert la == lb and a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bos,eos", [(None, None), (1, None), (None, 2),
                                     (1, 2)])
def test_transcript_dataset_matches_jax(tmp_path, bos, eos):
    labels = list(" abcdeghiknostuàáạ")
    path = tmp_path / "lm.txt"
    path.write_text("ba con gà\n\n  hai cái bát  \nxyz không\ncá kho\n",
                    encoding="utf-8")
    got = dataset.TranscriptDataset(str(path), CharTokenizer(labels),
                                    bos_id=bos, eos_id=eos)
    want = jax_ds.TranscriptDataset(str(path), JaxTokenizer(labels),
                                    bos_id=bos, eos_id=eos)
    assert len(got) == len(want) > 0
    assert [got[i] for i in range(len(got))] \
        == [want[i] for i in range(len(want))]
