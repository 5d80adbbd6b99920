"""Spans and counters at the port's layer boundaries, live only while a
`torch.profiler` session records.

`span(name)` is a context manager; `count(name, n=1)` adds to a
counter. Off (no profiler recording on this thread, or inside
`torch.compile` / `torch.export` tracing) `span` returns one shared null
context and `count` returns at once: each costs one test of the
profiler's state. `torch.profiler.record_function` costs ~10 us a call
even with no profiler running, so it is entered only when on.

On, a span is a `record_function("vietasr.<name>")` range, on the
profiler's clock beside the kernels and copies it launched, so any chrome
trace of the program shows what the host was doing across each device
gap, and which span holds which. The span also adds to its name's totals:
how many, their time, and their self time (a span's time less that of
the spans directly inside it on its thread). Nothing is kept a span, so a
long session grows nothing and leaves the garbage collector nothing to
sweep.

`summary()` gives the totals and the counters of the newest profiler
session: a session begins at the first span or count that finds the
profiler on after one that found it off, so what an earlier profiler
recorded does not leak into a later one. (Two sessions with no span or
count run between them read as one.)

Turn it on by running any code under `torch.profiler.profile()`, under
the Trainer's `profile_dir` window, or in a traced benchmark run; there is
no other switch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch

PREFIX = "vietasr."

# torch.export folds this one to a constant while tracing
_profiler_on = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class _Session:
    """The newest session's totals and counters. `live` is True from the
    session's first span or count until its owner thread (the one that
    began it, where the profiler runs) finds the profiler off; the lock
    is taken only while tracing is on."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.live = False
        self.owner = None
        self.spans: Dict[str, List[int]] = {}   # name -> [n, ns, self ns]
        self.counts: Dict[str, int] = {}

    def begin(self) -> None:
        with self.lock:
            if self.live:          # another thread began it
                return
            self.spans = {}
            self.counts = {}
            self.owner = threading.get_ident()
            self.live = True

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_S = _Session()


def enabled() -> bool:
    """True while a profiler records on this thread, outside compilation.
    Sites whose counts cost something to compute test this first."""
    if not _profiler_on():
        if _S.live and _S.owner == threading.get_ident():
            _S.live = False
        return False
    if torch.compiler.is_compiling():
        return False
    if not _S.live:
        _S.begin()
    return True


class _Span:
    __slots__ = ("name", "rf", "start", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _S.stack().append(self)
        self.inner = 0
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.start
        self.rf.__exit__(*exc)
        stack = _S.stack()
        stack.pop()
        if stack:
            stack[-1].inner += ns
        with _S.lock:
            tot = _S.spans.get(self.name)
            if tot is None:
                tot = _S.spans[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += ns
            tot[2] += ns - self.inner
        return False


def span(name: str):
    """A context manager timing the enclosed work as `name`; the shared
    null context when tracing is off."""
    if enabled():
        return _Span(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while tracing is on."""
    if enabled():
        with _S.lock:
            _S.counts[name] = _S.counts.get(name, 0) + n


def summary() -> dict:
    """{span name: {"n", "total_s", "self_s"}} over the newest session,
    plus each counter under its name."""
    with _S.lock:
        out: dict = {name: {"n": n, "total_s": ns * 1e-9,
                            "self_s": own * 1e-9}
                     for name, (n, ns, own) in _S.spans.items()}
        out.update(_S.counts)
    return out
