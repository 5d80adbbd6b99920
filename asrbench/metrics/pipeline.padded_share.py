"""The zero padding's share of the samples the pipeline padded its rows
to (each row a forward's bucket long): the program's
`pipeline.padded_samples` over it and `pipeline.signal_samples`, in the
traced stretch. The host fills, uploads and computes on that share for
nothing."""

from asrbench.spans import padded_share


def read(tr):
    return padded_share("pipeline")
