"""Host milliseconds a train step spends uploading its batch from pageable
memory (which also waits for the stream's queued work): the program's
`train.upload` span over its `train.steps` counter, in the traced
stretch."""

from asrbench.spans import ms_per


def read(tr):
    return ms_per(["train.upload"], "train.steps", "total_s")
