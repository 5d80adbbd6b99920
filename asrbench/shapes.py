"""Shapes of the traced stretch's work, as the per-layer readers count
them: each forward's rows, bucket and valid feature frames; each train
step's rows, encoder frames and transcript lengths."""

from __future__ import annotations

import numpy as np

from asrbench.counts import frontend
from asrbench.counts.quartznet import block_frames


def hop(fcfg: dict) -> int:
    return int(fcfg["window_stride"] * fcfg["sample_rate"])


def forwards(tr: dict):
    """[(rows, bucket samples, padded feature frames, valid feature frames
    per row)] of the stretch's forwards."""
    fcfg = tr["config"]["featurizer"]
    out = []
    for rows, samples, lens in tr.get("forwards") or []:
        t_feat = frontend.shape(fcfg, samples)[1]
        frames = -(-np.asarray(lens, np.int64) // hop(fcfg))
        out.append((rows, samples, t_feat, frames))
    return out


def steps(tr: dict):
    """[(rows, bucket samples, padded feature frames, valid feature frames
    per row, encoder frames, encoder frames per row, transcript lengths,
    lattice width)] of the stretch's train steps."""
    cfg = tr["config"]
    fcfg = cfg["featurizer"]
    out = []
    for shape, lens, tlen, l_max in tr.get("batches") or []:
        rows, samples = shape
        t_feat = frontend.shape(fcfg, samples)[1]
        frames = -(-np.asarray(lens, np.int64) // hop(fcfg))
        t_enc, enc = block_frames(cfg["blocks"], t_feat, frames)[-1]
        out.append((rows, samples, t_feat, frames, t_enc, enc,
                    np.asarray(tlen), 2 * l_max + 1))
    return out


def share(bound_s: float, took_s: float):
    """A bound over the time taken, in %; None where nothing ran."""
    return 100.0 * bound_s / took_s if took_s > 0 and bound_s > 0 else None
