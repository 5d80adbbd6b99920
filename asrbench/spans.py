"""Readers of the program's own spans and counters: its
`vietasr_tpu_torch.utils.tracing.summary()`, which holds what the program
recorded while the traced stretch's profiler ran (its newest session).

A program without that module, or a session that holds none of the work
the metric divides by, gives None, and the metric is left out of the
line."""

from __future__ import annotations

from typing import Optional, Sequence


def summary() -> Optional[dict]:
    try:
        from vietasr_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.summary()


def ms_per(spans: Sequence[str], unit: str, field: str = "self_s"):
    """Milliseconds of the spans' `field` ("self_s" or "total_s")
    together, over the counter `unit`."""
    s = summary()
    if s is None or not s.get(unit):
        return None
    return 1e3 * sum(s[n][field] for n in spans if n in s) / s[unit]


def padded_share(layer: str):
    """The zero padding's share of the samples `layer` ("pipeline" or
    "train") padded its rows to, in %."""
    s = summary()
    if s is None:
        return None
    padded = s.get(layer + ".padded_samples", 0)
    whole = padded + s.get(layer + ".signal_samples", 0)
    return 100.0 * padded / whole if whole else None


def padding_s_per_row(tr: dict, layer: str):
    """Seconds of zero padding a row of `layer` carries, at the cell's
    sample rate."""
    s = summary()
    if s is None or not s.get(layer + ".rows"):
        return None
    rate = tr["config"]["featurizer"]["sample_rate"]
    return s.get(layer + ".padded_samples", 0) / rate / s[layer + ".rows"]
