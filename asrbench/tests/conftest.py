"""Shared fixtures of the benchmark's own tests: run from the repository
root, `python -m pytest asrbench/tests -q`. Tests marked `cuda` need the
card; they decide inside the fixture whether one is present."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's kernels have no CPU "
                    "mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_run():
    """Run a cell once on the CPU at a small size: (workload, seed,
    overrides, extra argv, trace) -> the result dict."""
    import torch

    from asrbench import run

    def go(workload, overrides, *argv, trace=0, seed=4000000123,
           seconds=1.0):
        args = run.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace),
                          *argv])
        return run.execute(args, device=torch.device("cpu"),
                           overrides=overrides)
    return go


# small shapes of each mix for the CPU: few and short utterances
SMALL = {"offline_greedy_b32": {"utterances": 6, "max_s": 3.0,
                                "max_batch": 3, "judged_forwards": 2},
         "train_bucketed_b64": {"clips": 12, "max_s": 3.0, "batch": 4,
                                "max_tokens": 64}}
