"""The traffic is a function of the seed: the same seed gives the same
utterances and transcripts, another seed other ones, every seed the same
multiset of lengths."""

import numpy as np

from asrbench import core, synth

LABELS = core.config("qn12x1_vi")["labels"]


def test_same_seed_same_traffic():
    a, ta = synth.utterances(2 ** 31 + 12345, 20, 1.5, 16.7, LABELS)
    b, tb = synth.utterances(2 ** 31 + 12345, 20, 1.5, 16.7, LABELS)
    assert ta == tb
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_other_seed_other_traffic_same_lengths():
    a, ta = synth.utterances(7, 20, 1.5, 16.7, LABELS)
    b, tb = synth.utterances(8, 20, 1.5, 16.7, LABELS)
    assert ta != tb
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert sorted(map(len, a)) == synth.quantile_lengths(
        20, 1.5, 16.7).tolist()


def test_every_utterance_holds_words_of_its_transcript():
    sigs, texts = synth.utterances(3, 30, 1.5, 16.7, LABELS)
    bank = synth.word_bank(LABELS)
    for s, t in zip(sigs, texts):
        assert t and all(w in bank for w in t.split())
        assert sum(len(bank[w]) for w in t.split()) <= len(s)
        assert float(np.abs(s).max()) <= 1.0
