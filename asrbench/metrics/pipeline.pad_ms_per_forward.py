"""Host milliseconds a forward spends zero-filling a batch's rows and
copying the signals in: the self time of the program's `pipeline.pad`
span (its `pipeline.buffer_wait` child left out) over its
`pipeline.forwards` counter, in the traced stretch."""

from asrbench.spans import ms_per


def read(tr):
    return ms_per(["pipeline.pad"], "pipeline.forwards")
