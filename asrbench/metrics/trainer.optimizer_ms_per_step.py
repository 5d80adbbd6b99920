"""Host milliseconds a train step spends in the update: the gradient norm,
the finite guard, the optimizer's per-tensor loop and the BN statistics
(the self time of the program's `train.optimizer` span) over its
`train.steps` counter, in the traced stretch."""

from asrbench.spans import ms_per


def read(tr):
    return ms_per(["train.optimizer"], "train.steps")
