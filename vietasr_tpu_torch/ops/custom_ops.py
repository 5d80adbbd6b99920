"""The kernel wrappers as torch.library custom ops, for torch.export.

torch.export traces a program with fake tensors and cannot trace a
ctypes launch. So each kernel wrapper on the exported forward is also
registered as an op `vietasr::<name>`: `repeat_block`
(ops/repeat_block.py), `log_mel_tiles` (both frontend kernels,
frontend/cuda_frontend.py) and, for completeness, `beam_search`
(ops/fused_beam.py). An op's implementation is the wrapper's own route:
the kernel for CUDA tensors (its launches counted as always), the
kernel's plain version for CPU tensors, which is what the wrapper runs
there anyway. Its fake implementation gives the output shapes. Importing
`vietasr_tpu_torch` registers the ops, so an exported program that calls
them loads after that import.

The wrappers call their op only inside `through_ops()`, which
`export.export_transcriber` enters while it traces; the eager forward
calls the launches directly, since each op call costs the host a
dispatch on a host-bound path.
"""

from __future__ import annotations

import contextlib

_state = {"on": False}


@contextlib.contextmanager
def through_ops():
    """While active, the kernel wrappers call their `vietasr::` ops."""
    old = _state["on"]
    _state["on"] = True
    try:
        yield
    finally:
        _state["on"] = old


def active() -> bool:
    return _state["on"]
