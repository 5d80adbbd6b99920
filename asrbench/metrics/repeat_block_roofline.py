"""The one-repeat block kernel's least time over the rows inside their
lengths at the stretch's real shapes (asrbench/counts/repeat_block.py) over
its CUPTI time."""

from asrbench import shapes
from asrbench.counts import repeat_block
from asrbench.trace import kernel_seconds


def read(tr):
    cfg = tr["config"]
    bound = sum(repeat_block.forward(cfg["blocks"],
                                     cfg["featurizer"]["features"], rows,
                                     t_feat, frames, "one")[0]
                for rows, _, t_feat, frames in shapes.forwards(tr))
    return shapes.share(bound, kernel_seconds(tr, "repeat_kernel"))
