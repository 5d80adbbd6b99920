"""Host milliseconds a train step waits for its batch: the program's
`train.batch_wait` span (the prefetch queue's get, or the batcher) over
its `train.steps` counter, in the traced stretch."""

from asrbench.spans import ms_per


def read(tr):
    return ms_per(["train.batch_wait"], "train.steps", "total_s")
