"""Run one cell of the benchmark once and print its result line.

    python3 asrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. `--trace 0` prints the cell's end-to-end
metrics; `--trace 1` traces a few seconds of the window and prints its
per-layer metrics, with `busy_s`, `window_s` and a `breakdown`. The last
line of standard output is one JSON object: correct, attempted, failed,
metrics, device, (breakdown,) checks. Each compared number and its limit
also end standard error. Exits non-zero, printing no result, where no
CUDA device is present (or fewer than the cell asks for), or where a
module of JAX or of the JAX package was loaded.

`--control <name>` runs a control or a fault in the program's place, for
setting the limits (asrbench/tests and PERF.md); the benchmark's own runs
never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from asrbench import core  # noqa: E402

TRACE_START_S = 1.0       # the traced stretch starts this far into the window
TRACE_SECONDS = 3.0       # and covers whole calls or steps for this long


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None)
    return p.parse_args(argv)


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def execute(args, *, device=None, overrides=None, root=ROOT):
    """One run: returns the result dict (correct, attempted, failed,
    metrics, device, breakdown, checks). `device` and `overrides` (keys
    of the traffic mix) are for the tests, which run on the CPU at a small
    size; a benchmark run passes neither."""
    import torch

    core.fixed_cache_dirs(root)
    w = core.workload(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < w["chips"]:
            raise SystemExit(f"asrbench: {w['chips']} CUDA device(s) needed, "
                             f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats()
    mix = dict(core.traffic(w["traffic"], root), **(overrides or {}))
    tmpdir = tempfile.mkdtemp(prefix="asrbench-")
    ctx = SimpleNamespace(
        config=core.config(w["config"], root), traffic=mix,
        limits=core.limits(args.workload, root), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), control=args.control,
        device=device, tmpdir=tmpdir, t_start=T_START,
        trace_start_s=min(TRACE_START_S, args.seconds / 4),
        trace_seconds=min(TRACE_SECONDS, args.seconds / 2))
    try:
        driver = core.load("drivers", mix["driver"], root)
        res = driver.run(ctx)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    metrics_of = core.cell_metrics(args.workload, root)
    out_metrics = {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": w["chips"],
                "memory_peak_bytes": int(res["memory_peak_bytes"])}
    result = {}
    if args.trace and res.get("trace") is not None:
        tr = res["trace"]
        tr.update(config=ctx.config, traffic=mix, info=res["info"])
        for m in metrics_of["per_layer"]:
            value = core.load("metrics", m["name"], root).read(tr)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    elif not args.trace:
        for m in metrics_of["end_to_end"]:
            if m["name"] in res["metrics"]:
                out_metrics[m["name"]] = {"value": res["metrics"][m["name"]],
                                          "unit": m["unit"]}
    checks = res["checks"]
    result = dict(correct=core.checks_ok(checks), attempted=res["attempted"],
                  failed=res["failed"], metrics=out_metrics, device=dev_info,
                  **result, info=dict(res["info"], power=power_limit()
                                      if device.type == "cuda" else None),
                  checks=checks)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    result = execute(args)
    found = core.forbidden_modules()
    if found:
        print(f"asrbench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, ensure_ascii=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
