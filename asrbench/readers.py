"""Readers that more than one per-layer metric shares: each metric's file
under asrbench/metrics/ names one of these as its `read`."""

from __future__ import annotations

from asrbench import peaks, shapes
from asrbench.counts.quartznet import forward_flops


def device_idle(tr):
    """1 - the union of the device's busy intervals (kernels, copies,
    sets) over the traced stretch's wall, in %; None where the stretch
    holds no forward and no train step."""
    if not (tr.get("forwards") or tr.get("batches")):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(tr):
    """The FLOPs of the stretch's work at the rows' real lengths (the
    encoder and head, from the block list) over the stretch's wall at the
    bf16 dense peak, 989 TFLOP/s: each forward once, each train step three
    times its forward (the forward, and the backward's two products)."""
    cfg = tr["config"]
    n_out = len(cfg["labels"]) + 1
    feat_in = cfg["featurizer"]["features"]
    flops = sum(forward_flops(cfg["blocks"], feat_in, n_out, frames, t_feat)
                for _, _, t_feat, frames in shapes.forwards(tr))
    flops += sum(3.0 * forward_flops(cfg["blocks"], feat_in, n_out, frames,
                                     t_feat)
                 for _, _, t_feat, frames, *_ in shapes.steps(tr))
    return shapes.share(flops / peaks.BF16_FLOPS, tr["window_s"])
