"""The result line: the keys the contract names, `checks` last, and no
result without a card; the per-layer metrics in a traced run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from asrbench import core
from asrbench.tests.conftest import SMALL

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload, trace", [
    ("qn12x1_vi.greedy_b32", 0), ("qn12x1_vi.greedy_b32", 1),
    ("qn12x1_vi.train_b64", 0)])
def test_result_keys(cpu_run, workload, trace):
    mix = core.workload(workload)["traffic"]
    res = cpu_run(workload, SMALL[mix], trace=trace)
    keys = list(res)
    want = REQUIRED + (["breakdown"] if trace else [])
    # `info` (the run's own record) and the compared numbers, last
    assert keys == want + ["info", "checks"]
    assert json.loads(json.dumps(res)) == res
    assert res["correct"] is True and res["failed"] == 0
    names = [m["name"] for m in core.cell_metrics(workload)[
        "per_layer" if trace else "end_to_end"]]
    assert set(res["metrics"]) <= set(names)
    if not trace:
        assert "setup_s" in res["metrics"]
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, (value, limit) in res["checks"].items():
        assert value <= limit, name


def _no_card_run(cwd):
    return subprocess.run(
        [sys.executable, "asrbench/run.py", "--workload",
         "qn12x1_vi.greedy_b32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _no_card_run(core.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(core.ROOT, "asrbench"),
                    os.path.join(tmp_path, "asrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _no_card_run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
