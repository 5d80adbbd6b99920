"""Seconds of zero padding a training clip carries to its batch's length:
the program's `train.padded_samples` over its `train.rows`, in the traced
stretch."""

from asrbench.spans import padding_s_per_row


def read(tr):
    return padding_s_per_row(tr, "train")
