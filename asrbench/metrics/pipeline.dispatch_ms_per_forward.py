"""Host milliseconds a forward spends issuing its work to the device: the
self time of the program's `pipeline.upload`, `pipeline.featurize`,
`pipeline.encoder` and `pipeline.greedy` spans over its
`pipeline.forwards` counter, in the traced stretch."""

from asrbench.spans import ms_per


def read(tr):
    return ms_per(["pipeline.upload", "pipeline.featurize",
                   "pipeline.encoder", "pipeline.greedy"],
                  "pipeline.forwards")
