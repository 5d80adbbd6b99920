"""A new configuration, traffic mix, cell and per-layer metric are files
of their own: added to a copy of the benchmark, the harness finds and runs
them and no file of the harness changes."""

import hashlib
import json
import os
import shutil

from asrbench import core
from asrbench.tests.conftest import SMALL


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "asrbench")):
        for f in files:
            if "__pycache__" in d or ".cache" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_added_files_are_found_and_run(tmp_path, cpu_run):
    root = str(tmp_path)
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(core.ROOT, "asrbench"),
                    os.path.join(root, "asrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digest(root)
    a = os.path.join(root, "asrbench")
    cfg = dict(core.config("qn12x1_vi"), name="tiny_vi")
    cfg["blocks"] = cfg["blocks"][:1] + cfg["blocks"][-1:]
    cfg["weights"] = {"kind": "seeded"}
    with open(os.path.join(a, "configs", "tiny_vi.json"), "w") as f:
        json.dump(cfg, f)
    mix = dict(core.traffic("offline_greedy_b32"), **SMALL[
        "offline_greedy_b32"])
    with open(os.path.join(a, "traffic", "tiny_mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(a, "limits", "tiny_vi.tiny_mix.json"), "w") as f:
        json.dump({"lens_mismatch": 0, "text_mismatch": 0}, f)
    with open(os.path.join(a, "metrics", "tiny.utterances.py"), "w") as f:
        f.write("def read(tr):\n    return float(tr['utterances'])\n")
    bench = core.benchmark(root)
    bench["configs"].append({"name": "tiny_vi", "source": "test",
                             "file": "asrbench/configs/tiny_vi.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_vi.tiny_mix",
                               "config": "tiny_vi", "traffic": "tiny_mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tiny.utterances", "unit": "n",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "pipeline", "moves": "audio_s_per_s",
                               "workloads": ["tiny_vi.tiny_mix"]})
    bench["end_to_end"][0]["workloads"].append("tiny_vi.tiny_mix")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    files = core.cell_files("tiny_vi.tiny_mix", root)
    assert files["config"] == "asrbench/configs/tiny_vi.json"
    assert files["driver"] == "asrbench/drivers/offline.py"
    assert "asrbench/metrics/tiny.utterances.py" in files["metrics"]
    assert all(os.path.exists(os.path.join(root, p)) for p in
               [files["config"], files["traffic"], files["driver"],
                files["limits"], *files["metrics"]])

    import torch
    from asrbench import run
    args = run.parse(["--workload", "tiny_vi.tiny_mix", "--seed", "5",
                      "--seconds", "1", "--trace", "1"])
    res = run.execute(args, device=torch.device("cpu"), root=root)
    assert res["metrics"]["tiny.utterances"]["value"] > 0
    assert res["correct"]
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
