"""The zero padding's share of the samples the trainer's batches hold:
the program's `train.padded_samples` over it and `train.signal_samples`,
in the traced stretch. The step uploads and computes on that share for
nothing."""

from asrbench.spans import padded_share


def read(tr):
    return padded_share("train")
