"""On the card, at each cell's own size and a short window: a sound run
is correct, each control is not. `python -m pytest asrbench/tests -q -m
cuda` on the chip."""

import json
import subprocess
import sys

import pytest

from asrbench import core

CASES = [("qn12x1_vi.greedy_b32", None, True),
         ("qn12x1_vi.greedy_b32", "int8", False),
         ("qn12x1_vi.greedy_b32", "fast", False),
         ("qn15x5_vi.greedy_b32", None, True),
         ("qn15x5_vi.greedy_b32", "int8", False),
         ("qn15x5_vi.greedy_b32", "fast", False),
         ("qn12x1_vi.train_b64", None, True),
         ("qn12x1_vi.train_b64", "fp8", False),
         ("qn12x1_vi.train_b64", "half_batch", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload, control, correct", CASES)
def test_cell_on_the_card(cuda_device, workload, control, correct):
    argv = [sys.executable, "asrbench/run.py", "--workload", workload,
            "--seed", "4294967311", "--seconds", "5", "--trace", "0"]
    if control:
        argv += ["--control", control]
    out = subprocess.run(argv, cwd=core.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is correct, res["checks"]
    assert res["device"]["platform"] == "gpu"
