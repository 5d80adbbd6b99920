"""vietasr_tpu_torch's data path (audio/cleaners.py, manifest.py,
dataset.py, augment.py) vs the JAX package's, on WAVs written from seeded
numpy into tmp_path.

Both sides are numpy and scipy drawing from `random.Random` /
`np.random.RandomState` objects seeded alike, so manifests, dataset items,
batches and augmented waveforms are held equal bit for bit.
"""

import json
import random

import numpy as np
import pytest
from scipy.io import wavfile

from vietasr_tpu.audio import augment as jax_aug
from vietasr_tpu.audio import cleaners as jax_cleaners
from vietasr_tpu.audio import dataset as jax_ds
from vietasr_tpu.audio import manifest as jax_manifest
from vietasr_tpu.audio.io import AudioSegment as JaxSegment
from vietasr_tpu.audio.tokenizer import CharTokenizer as JaxTokenizer
from vietasr_tpu_torch import audio as port_audio
from vietasr_tpu_torch.audio import augment, cleaners, dataset, manifest
from vietasr_tpu_torch.audio.io import AudioSegment

LABELS = list(" abcdeghiknostuàáạ")
TEXTS = ["ba con gà", "hai cái bát", "các bạn", "to nhỏ", "cá kho",
         "bà ba", "chào các bạn", "một hai ba"]


def _write_wav(path, seconds, sr=16000, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(int(seconds * sr)) * 3000).clip(-32768, 32767)
    wavfile.write(str(path), sr, x.astype(np.int16))
    return str(path)


def _corpus(tmp_path, durations, *, sr=16000):
    """A JSON-lines manifest of WAVs of the given durations."""
    lines = []
    for i, d in enumerate(durations):
        wav = _write_wav(tmp_path / f"u{i}.wav", d, sr=sr, seed=i)
        lines.append({"audio_filepath": wav, "duration": d,
                      "text": TEXTS[i % len(TEXTS)]})
    path = tmp_path / "train.json"
    path.write_text("".join(json.dumps(l, ensure_ascii=False) + "\n"
                            for l in lines), encoding="utf-8")
    return str(path)


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("signal", "signal_lens", "tokens", "token_lens"):
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k


# ---------------------------------------------------------------------------
# cleaners, manifests


@pytest.mark.parametrize("text", [
    "Dr. Smith paid 1,250 dollars on 3 May", "Mr. and Mrs. Lee, Jr.",
    "Xin chào, các bạn! 21 tuổi.", "  spaces\tand\nnewlines  ", "0", "-7",
    "1000000007 items", "It's St. John's Co. Ltd.", "ĐƯỜNG 19 ĐẸP"])
def test_cleaners_match_jax(text):
    assert cleaners.clean_text(text) == jax_cleaners.clean_text(text)
    assert cleaners.clean_text(text, lowercase=False, table="vi") \
        == jax_cleaners.clean_text(text, lowercase=False, table="vi")
    assert cleaners.tokenize_clean(text) == jax_cleaners.tokenize_clean(text)
    assert cleaners.expand_numbers(text) == jax_cleaners.expand_numbers(text)
    assert cleaners.expand_abbreviations(text) \
        == jax_cleaners.expand_abbreviations(text)
    for n in (0, 7, 19, 20, 99, 100, 101, 999, 1001, 123456789, -42):
        assert cleaners.number_to_words(n) == jax_cleaners.number_to_words(n)


def test_manifest_reading_matches_jax(tmp_path):
    (tmp_path / "t.txt").write_text("văn bản\nhai dòng", encoding="utf-8")
    lines = [{"audio_filename": "a.wav", "duration": 1.5, "text": "một"},
             {"audio_filepath": "~/b.wav", "duration": 0.05, "text": "hai"},
             {"audio_filepath": "c.wav", "duration": 20.0, "text": "ba",
              "offset": 0.5},
             {"audio_filepath": "d.wav", "duration": 3,
              "text_filepath": str(tmp_path / "t.txt"), "speaker": "s1"},
             {"audio_filepath": "e.wav", "duration": 2.5, "text": "năm"}]
    m1, m2 = tmp_path / "m1.json", tmp_path / "m2.json"
    m1.write_text("\n".join(json.dumps(l, ensure_ascii=False)
                            for l in lines[:3]) + "\n\n", encoding="utf-8")
    m2.write_text("\n".join(json.dumps(l, ensure_ascii=False)
                            for l in lines[3:]), encoding="utf-8")
    both = f"{m1},{m2}"
    assert [e.__dict__ for e in manifest.iter_manifest(both)] \
        == [e.__dict__ for e in jax_manifest.iter_manifest(both)]
    for kw in ({}, dict(min_duration=0.1, max_duration=16.7),
               dict(sort_by_duration=True), dict(max_number=2),
               dict(min_duration=1.0, sort_by_duration=True)):
        got = manifest.read_manifest([str(m1), str(m2)], **kw)
        want = jax_manifest.read_manifest([str(m1), str(m2)], **kw)
        assert [e.__dict__ for e in got] == [e.__dict__ for e in want]
        assert manifest.read_manifest.last_filtered_duration \
            == jax_manifest.read_manifest.last_filtered_duration
    out_p, out_j = tmp_path / "p.json", tmp_path / "j.json"
    entries = manifest.read_manifest(both)
    manifest.write_manifest(str(out_p), entries)
    jax_manifest.write_manifest(str(out_j), jax_manifest.read_manifest(both))
    assert out_p.read_bytes() == out_j.read_bytes()
    bad = tmp_path / "bad.json"
    for line in ({"duration": 1, "text": "x"}, {"audio_filepath": "a"},
                 {"audio_filepath": "a", "duration": 1}):
        bad.write_text(json.dumps(line))
        with pytest.raises(ValueError):
            manifest.read_manifest(str(bad))


# ---------------------------------------------------------------------------
# dataset, batcher


def test_dataset_items_match_jax(tmp_path):
    """16 kHz and 8 kHz WAVs (resampled on read), an offset entry, trimming,
    an unmappable transcript dropped."""
    path = _corpus(tmp_path, [1.2, 0.7, 2.3])
    wav8 = _write_wav(tmp_path / "n8.wav", 1.1, sr=8000, seed=9)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps({"audio_filepath": wav8, "duration": 1.1,
                            "text": "bà ba"}) + "\n")
        f.write(json.dumps({"audio_filepath": wav8, "duration": 0.4,
                            "offset": 0.3, "text": "cá"}) + "\n")
        f.write(json.dumps({"audio_filepath": wav8, "duration": 0.4,
                            "text": "xyz!"}) + "\n")
    for trim in (False, True):
        got = dataset.AudioTextDataset(
            manifest.read_manifest(path),
            port_audio.CharTokenizer(LABELS), trim=trim)
        want = jax_ds.AudioTextDataset(
            jax_manifest.read_manifest(path), JaxTokenizer(LABELS), trim=trim)
        assert len(got) == len(want) == 5
        assert got.num_dropped == want.num_dropped == 1
        assert got.max_token_len() == want.max_token_len()
        for i in range(len(want)):
            (gs, gi), (ws, wi) = got[i], want[i]
            assert gs.dtype == ws.dtype == np.float32
            assert np.array_equal(gs, ws) and gi == wi


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_shards=2, shard_id=0), dict(num_shards=2, shard_id=1),
    dict(num_shards=3, shard_id=2), dict(drop_last=True, seed=1),
    dict(bucket_margin=1.0 / 0.9, seed=5),
    dict(shuffle=False, max_duration=2.0),
    dict(buckets=[8000, 24000, 40000], seed=3),
], ids=["plain", "shard0of2", "shard1of2", "shard2of3", "drop_last",
        "margin", "noshuffle_overlong", "buckets"])
def test_bucket_batcher_matches_jax_over_two_epochs(tmp_path, kw):
    durations = [0.6, 1.9, 2.4, 0.9, 1.3, 2.5, 0.4, 1.7, 3.1, 0.8, 2.05,
                 1.1, 0.5]
    path = _corpus(tmp_path, durations)
    got_ds = dataset.AudioTextDataset(manifest.read_manifest(path),
                                      port_audio.CharTokenizer(LABELS))
    want_ds = jax_ds.AudioTextDataset(jax_manifest.read_manifest(path),
                                      JaxTokenizer(LABELS))
    kw = dict(dict(max_duration=2.6), **kw)
    got = dataset.BucketBatcher(got_ds, 3, **kw)
    want = jax_ds.BucketBatcher(want_ds, 3, **kw)
    assert got.buckets == want.buckets
    assert got.steps_per_epoch() == want.steps_per_epoch()
    for _ in range(2):
        _batches_equal(got, want)
        assert got.num_skipped_too_long == want.num_skipped_too_long
    if kw.get("max_duration") == 2.0:
        assert got.num_skipped_too_long > 0
    assert got.epoch == want.epoch == 2
    assert dataset.batch_sample_stats(got) \
        == jax_ds.batch_sample_stats(want)


def test_buckets_and_padding_match_jax():
    for args in ((16.7, 16000), (2.0, 8000, 3), (10.0, 16000, 1)):
        assert dataset.default_buckets(*args) == jax_ds.default_buckets(*args)
    x = np.arange(10, dtype=np.float32)
    for n in (4, 10, 13):
        assert np.array_equal(dataset.pad_to_bucket(x, n),
                              jax_ds.pad_to_bucket(x, n))


def test_audio_package_exports_match_jax():
    import vietasr_tpu.audio as jax_audio

    assert sorted(port_audio.__all__) == sorted(jax_audio.__all__)


# ---------------------------------------------------------------------------
# augmentation


def _signal(seed=0, n=16000):
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


def _perturb(cls_port, cls_jax, make_args, seed, sig, sr=16000):
    """Apply one perturbation (3 draws in a row) from each package."""
    outs = []
    for cls, seg_cls in ((cls_port, AudioSegment), (cls_jax, JaxSegment)):
        p = cls(**make_args(seed))
        res = []
        for _ in range(3):
            seg = seg_cls(samples=sig.copy(), sample_rate=sr)
            p.perturb(seg)
            res.append(np.asarray(seg.samples))
        outs.append(res)
    return outs


def _noise_manifest(tmp_path, name, durations, sr=16000):
    lines = [{"audio_filepath": _write_wav(tmp_path / f"{name}{i}.wav", d,
                                           sr=sr, seed=100 + i),
              "duration": d, "text": "n"} for i, d in enumerate(durations)]
    path = tmp_path / f"{name}.json"
    path.write_text("".join(json.dumps(l) + "\n" for l in lines))
    return str(path)


PERTURBATIONS = {
    "speed": ("SpeedPerturbation",
              lambda s: dict(min_speed_rate=0.9, max_speed_rate=1.1,
                             rng=random.Random(s))),
    "pitch": ("PitchPerturbation",
              lambda s: dict(min_steps=-2.0, max_steps=2.0,
                             rng=random.Random(s))),
    "gain": ("GainPerturbation",
             lambda s: dict(min_gain_dbfs=-6, max_gain_dbfs=6,
                            rng=random.Random(s))),
    "shift": ("ShiftPerturbation",
              lambda s: dict(min_shift_ms=-50.0, max_shift_ms=50.0,
                             rng=random.Random(s))),
    "white_noise": ("WhiteNoisePerturbation",
                    lambda s: dict(min_level=-60, max_level=-38,
                                   rng=np.random.RandomState(s))),
}


@pytest.mark.parametrize("name", sorted(PERTURBATIONS))
def test_perturbations_match_jax(name):
    cls_name, make_args = PERTURBATIONS[name]
    got, want = _perturb(getattr(augment, cls_name),
                         getattr(jax_aug, cls_name), make_args, 7,
                         _signal(1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    p = getattr(augment, cls_name)(**make_args(0))
    assert p.max_augmentation_length(10.0) \
        == getattr(jax_aug, cls_name)(**make_args(0)) \
        .max_augmentation_length(10.0)


@pytest.mark.parametrize("kind", ["noise", "impulse"])
def test_file_perturbations_match_jax(tmp_path, kind):
    if kind == "noise":
        path = _noise_manifest(tmp_path, "noise", [0.5, 2.0, 1.2],
                               sr=8000)

        def make_args(s):
            return dict(manifest_path=path, min_snr_db=10, max_snr_db=20,
                        rng=random.Random(s))
        cls_name = "NoisePerturbation"
    else:
        path = _noise_manifest(tmp_path, "rir", [0.05, 0.1])

        def make_args(s):
            return dict(manifest_path=path, rng=random.Random(s))
        cls_name = "ImpulsePerturbation"
    got, want = _perturb(getattr(augment, cls_name),
                         getattr(jax_aug, cls_name), make_args, 11,
                         _signal(2))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # without a manifest nothing happens
    seg = AudioSegment(samples=_signal(3), sample_rate=16000)
    getattr(augment, cls_name)().perturb(seg)
    assert np.array_equal(seg.samples, _signal(3))


def test_pitch_shift_matches_jax():
    sig = _signal(4, 12000)
    for steps in (-3.0, -0.5, 0.0, 1.7, 4.0):
        got = augment.pitch_shift(sig, steps)
        want = jax_aug.pitch_shift(sig, steps)
        assert len(got) == len(sig) and np.array_equal(got, want)


def _augmentors(seed):
    out = []
    for mod in (augment, jax_aug):
        rng = np.random.RandomState(seed)
        out.append(mod.AudioAugmentor(perturbations=[
            (1.0, mod.SpeedPerturbation(0.9, 1.1, rng=rng)),
            (0.7, mod.GainPerturbation(-6, 6, rng=rng)),
            (0.7, mod.WhiteNoisePerturbation(-60, -38, rng=rng)),
            (0.7, mod.ShiftPerturbation(rng=rng))], rng=rng))
    return out


def test_audio_augmentor_matches_jax():
    """The CLI's recipe (one RandomState shared by the augmentor and every
    perturbation): 20 calls in a row equal; max_augmentation_length."""
    got, want = _augmentors(3)
    for i in range(20):
        sig = _signal(i, 8000 + 731 * i)
        g, w = got(sig.copy(), 16000), want(sig.copy(), 16000)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got.max_augmentation_length(5.0) \
        == want.max_augmentation_length(5.0) == pytest.approx(5.0 / 0.9)


def test_augmentor_from_config_matches_jax(tmp_path):
    noise = _noise_manifest(tmp_path, "noise", [1.5])
    config = [{"aug_type": "gain", "prob": 0.5,
               "cfg": {"min_gain_dbfs": -3, "max_gain_dbfs": 3}},
              {"aug_type": "noise", "prob": 1.0,
               "cfg": {"manifest_path": noise}},
              {"aug_type": "unknown", "prob": 1.0},
              {"aug_type": "shift", "prob": 1.0}]
    got = augment.AudioAugmentor.from_config(config)
    want = jax_aug.AudioAugmentor.from_config(config)
    assert [(p, type(t).__name__) for p, t in got._pipeline] \
        == [(p, type(t).__name__) for p, t in want._pipeline]
    assert sorted(augment.perturbation_types) \
        == sorted(jax_aug.perturbation_types)


def test_augmented_dataset_batches_match_jax(tmp_path):
    """AudioTextDataset + the augmentor + BucketBatcher with its margin, as
    the CLI builds them: two epochs of batches equal bit for bit."""
    path = _corpus(tmp_path, [0.6, 1.9, 1.3, 0.9, 1.7, 0.5, 1.1])
    (pa, ja) = _augmentors(1000)
    got = dataset.BucketBatcher(
        dataset.AudioTextDataset(manifest.read_manifest(path),
                                 port_audio.CharTokenizer(LABELS),
                                 augmentor=pa),
        2, max_duration=2.0, bucket_margin=1.0 / 0.9, seed=4)
    want = jax_ds.BucketBatcher(
        jax_ds.AudioTextDataset(jax_manifest.read_manifest(path),
                                JaxTokenizer(LABELS), augmentor=ja),
        2, max_duration=2.0, bucket_margin=1.0 / 0.9, seed=4)
    for _ in range(2):
        _batches_equal(got, want)
