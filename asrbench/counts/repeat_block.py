"""The one-repeat block kernel (csrc/repeat_block.cu, R = 1) and the
whole-block kernel (csrc/repeat_whole_block.cu, R >= 2) share one count:
the larger of the block's bf16 GEMM work on the tensor cores and its fp32
depthwise work on the CUDA cores (the two run side by side), or its
bytes. Only time rows inside their lengths need a product or their input
(a row past its length comes out as its bias alone), so the operations
and the bf16 input bytes count those rows, the output bytes every row,
the weights once. The intermediates of R > 1 are not counted: the block
needs none of them in memory."""

from __future__ import annotations

from typing import List

import numpy as np

from asrbench import peaks


def launch(bsz: int, t: int, c_in: int, c_out: int, k: int, r: int,
           has_res: bool, rows: int):
    """(least seconds, operations, bytes) of one block launch."""
    cs = [c_in] + [c_out] * (r - 1)
    gemm = sum(2 * rows * c * c_out for c in cs)
    gemm += 2 * rows * c_in * c_out if has_res else 0
    dw = sum(2 * rows * c * k for c in cs)
    nbytes = (2 * rows * c_in + 2 * bsz * t * c_out + 4 * bsz
              + sum(4 * k * c + 2 * c * c_out + 4 * c_out for c in cs)
              + ((2 * c_in * c_out + 4 * c_out) if has_res else 0))
    secs = max(gemm / peaks.BF16_FLOPS, dw / peaks.FP32_FLOPS,
               nbytes / peaks.HBM_BYTES)
    return secs, gemm + dw, nbytes


def eligible(b: dict) -> bool:
    """Blocks the repeat kernels take: separable, stride 1, no dilation."""
    return (b["separable"] and b["stride"][0] == 1
            and b["dilation"][0] == 1)


def forward(blocks: List[dict], feat_in: int, bsz: int, t_feat: int,
            frames: np.ndarray, repeat: str):
    """(least seconds, operations, bytes) summed over one forward's
    launches of one kernel: repeat="one" the R = 1 blocks, "whole" the
    R >= 2 ones. `frames` are the rows' valid feature frames, `t_feat`
    the padded frame count."""
    from asrbench.counts.quartznet import block_frames

    secs = ops = nbytes = 0.0
    c_in = feat_in
    for b, (t, lens) in zip(blocks, block_frames(blocks, t_feat, frames)):
        r = b["repeat"]
        if eligible(b) and (r == 1) == (repeat == "one"):
            rows = int(np.minimum(lens, t).sum())
            s, o, n = launch(bsz, t, c_in, b["filters"], b["kernel"][0], r,
                             b["residual"], rows)
            secs, ops, nbytes = secs + s, ops + o, nbytes + n
        c_in = b["filters"]
    return secs, ops, nbytes
