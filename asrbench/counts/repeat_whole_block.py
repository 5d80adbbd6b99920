"""The whole-block kernel (csrc/repeat_whole_block.cu): the count of
asrbench/counts/repeat_block.py over the R >= 2 blocks."""

from asrbench.counts.repeat_block import forward as _forward


def forward(blocks, feat_in, bsz, t_feat, frames):
    return _forward(blocks, feat_in, bsz, t_feat, frames, "whole")
