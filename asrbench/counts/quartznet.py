"""A QuartzNet forward's multiply-adds x 2 at the rows' real lengths,
from the block list: each sub-layer's depthwise taps and 1x1 (or dense
conv), each residual 1x1, and the head, over the frames inside each row's
length at that block."""

from __future__ import annotations

from typing import List

import numpy as np


def _out(lens, b):
    k, s, d = b["kernel"][0], b["stride"][0], b["dilation"][0]
    pad = (d * k) // 2 - 1 if d > 1 else k // 2
    return (lens + 2 * pad - d * (k - 1) - 1) // s + 1


def block_frames(blocks: List[dict], t_feat: int, frames: np.ndarray):
    """Per block: (padded output frames, each row's valid output frames)."""
    t, lens = t_feat, np.asarray(frames, np.int64)
    out = []
    for b in blocks:
        t, lens = int(_out(np.int64(t), b)), _out(lens, b)
        out.append((t, lens))
    return out


def forward_flops(blocks: List[dict], feat_in: int, n_out: int,
                  frames: np.ndarray, t_feat: int = 0) -> float:
    """Multiply-adds x 2 of the forward over rows of `frames` valid
    feature frames each."""
    total = 0.0
    c_in = feat_in
    per_block = block_frames(blocks, t_feat or int(np.max(frames)), frames)
    for b, (_, lens) in zip(blocks, per_block):
        k, f = b["kernel"][0], b["filters"]
        c = c_in
        per = 0.0
        for _ in range(b["repeat"]):
            per += (2.0 * k * c + 2.0 * c * f) if b["separable"] \
                else 2.0 * k * c * f
            c = f
        if b["residual"]:
            per += 2.0 * c_in * f
        total += float(lens.sum()) * per
        c_in = f
    return total + float(per_block[-1][1].sum()) * 2.0 * c_in * n_out
