"""Host milliseconds a forward spends blocked on the device: the self
time of the program's `pipeline.readback` (the greedy ids' read-back) and
`pipeline.buffer_wait` (a page-locked buffer's last upload) spans over
its `pipeline.forwards` counter, in the traced stretch."""

from asrbench.spans import ms_per


def read(tr):
    return ms_per(["pipeline.readback", "pipeline.buffer_wait"],
                  "pipeline.forwards")
