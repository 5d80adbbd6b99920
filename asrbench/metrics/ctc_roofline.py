"""The CTC alpha and beta kernels' least time at the stretch's steps
(asrbench/counts/ctc.py: encoder frames, transcript lengths, the lattice
width) over their CUPTI time together."""

from asrbench import shapes
from asrbench.counts import ctc
from asrbench.trace import kernel_seconds


def read(tr):
    bound = 0.0
    for *_, t_enc, enc, tlen, width in shapes.steps(tr):
        (a, _, _), (b, _, _) = ctc.launches(enc, tlen, t_enc, width)
        bound += a + b
    took = kernel_seconds(tr, "alpha_kernel") + kernel_seconds(
        tr, "beta_kernel")
    return shapes.share(bound, took)
