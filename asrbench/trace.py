"""The traced stretch of a `--trace 1` run: a `torch.profiler` (CUPTI)
trace of whole calls or steps inside the window, reduced to device
intervals, kernel times by name, copy bytes, and the benchmark's own
spans (`asrbench:*` ranges it opens around its calls into the program).

The trace goes to a file under TMPDIR only long enough to be read back.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Tuple

SPAN = "asrbench:"
STRETCH = SPAN + "stretch"


def span(name: str):
    """A host range named asrbench:<name>: recorded while a profiler runs,
    nearly free otherwise."""
    import torch
    return torch.profiler.record_function(SPAN + name)


class Stretch:
    """start() / stop() around whole calls or steps; stop() returns the
    reduced trace."""

    def __init__(self):
        self.prof = None
        self.rf = None

    def start(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.rf = torch.profiler.record_function(STRETCH)
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host_s = time.perf_counter() - self.t0
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        out = reduce(events)
        out["host_s"] = host_s
        return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def reduce(events: List[dict]) -> dict:
    """Chrome-trace events -> {window_s, busy_s, kernels {name: seconds},
    copies [(name, bytes)], idle_gaps [(span, seconds)], device_ops [(name,
    seconds)]}. Times in the trace are microseconds; the window is the
    stretch's own range, device work clipped to it."""
    stretch = [e for e in events if e.get("name") == STRETCH
               and e.get("ph") == "X"]
    if not stretch:
        raise RuntimeError("trace: the stretch's range is missing")
    w0 = stretch[0]["ts"]
    w1 = w0 + stretch[0]["dur"]
    dev, kernels, copies = [], {}, []
    spans = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            name = e["name"]
            kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
            if cat == "gpu_memcpy":
                copies.append((name, int(e.get("args", {}).get("bytes", 0))))
        elif cat == "user_annotation" and e["name"].startswith(SPAN) \
                and e["name"] != STRETCH:
            spans.append((a, b, e["name"][len(SPAN):]))
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        # the innermost span: the latest to start among those covering it
        label = max(inner, key=lambda s: s[0])[2] if inner else "host"
        named.append((label, (b - a) * 1e-6))
    named.sort(key=lambda g: -g[1])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels, "copies": copies,
            "idle_gaps": [list(g) for g in named[:10]],
            "device_ops": [list(o) for o in ops[:10]]}


def kernel_seconds(trace: dict, key: str) -> float:
    """Device seconds of the kernels whose name holds `key`."""
    return sum(s for n, s in trace["kernels"].items() if key in n)


def h2d_bytes(trace: dict) -> int:
    return sum(n for name, n in trace["copies"] if "HtoD" in name)
