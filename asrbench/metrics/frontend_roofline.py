"""The log-mel kernel's least time at the stretch's real shapes
(asrbench/counts/frontend.py, a launch a forward) over its CUPTI time."""

from asrbench import shapes
from asrbench.counts import frontend
from asrbench.trace import kernel_seconds


def read(tr):
    fcfg = tr["config"]["featurizer"]
    bound = sum(frontend.launch(fcfg, rows, samples)[0]
                for rows, samples, _, _ in shapes.forwards(tr))
    return shapes.share(bound, kernel_seconds(tr, "logmel_kernel"))
