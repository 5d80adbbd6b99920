"""Host milliseconds a train step spends issuing the forward and backward
of its microbatches: the self time of the program's
`train.forward_backward` span over its `train.steps` counter, in the
traced stretch."""

from asrbench.spans import ms_per


def read(tr):
    return ms_per(["train.forward_backward"], "train.steps")
