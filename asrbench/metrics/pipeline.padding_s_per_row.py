"""Seconds of zero padding an utterance carries to its bucket: the
program's `pipeline.padded_samples` over its `pipeline.rows`, in the
traced stretch."""

from asrbench.spans import padding_s_per_row


def read(tr):
    return padding_s_per_row(tr, "pipeline")
