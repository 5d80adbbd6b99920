"""The harness: finds a cell's files by name, runs its driver, reads its
per-layer metrics, prints the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name `BENCHMARK.json` gives it:

- asrbench/configs/<config>.json: the configuration as run (featurizer,
  block list, labels, weights, compute dtype), its source, cuts and
  assumptions;
- asrbench/traffic/<traffic>.json: the mix's parameters, and the driver
  that runs it (`"driver"`), asrbench/drivers/<driver>.py;
- asrbench/limits/<workload>.json: the limits of the numbers the cell's
  output check compares;
- asrbench/metrics/<metric>.py: a reader `read(ctx) -> float | None` of
  one per-layer metric from the traced stretch (None: nothing to read,
  and the metric is left out of the line);
- asrbench/counts/<kernel or model>.py: operations and bytes.

A later cell, mix or metric adds files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names a run must never hold (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "vietasr_tpu")


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, root: str = ROOT) -> dict:
    for w in benchmark(root)["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"asrbench: no workload {name!r} in BENCHMARK.json")


def config(name: str, root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "asrbench", "configs", name + ".json"))


def traffic(name: str, root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "asrbench", "traffic", name + ".json"))


def limits(name: str, root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "asrbench", "limits", name + ".json"))


def load(kind: str, name: str, root: str = ROOT):
    """asrbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(root, "asrbench", kind, name + ".py")
    mod_name = f"asrbench_{kind}_{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(wname: str, root: str = ROOT) -> Dict[str, List[dict]]:
    """{"end_to_end": [...], "per_layer": [...]}: the metrics this cell
    reports (a metric without a "workloads" list is every cell's)."""
    bench = benchmark(root)
    return {kind: [m for m in bench[kind]
                   if wname in m.get("workloads", [wname])]
            for kind in ("end_to_end", "per_layer")}


def cell_files(wname: str, root: str = ROOT) -> dict:
    """The files a cell is made of, found by name."""
    w = workload(wname, root)
    t = traffic(w["traffic"], root)
    rel = lambda *p: os.path.join("asrbench", *p)  # noqa: E731
    return {"config": rel("configs", w["config"] + ".json"),
            "traffic": rel("traffic", w["traffic"] + ".json"),
            "driver": rel("drivers", t["driver"] + ".py"),
            "limits": rel("limits", wname + ".json"),
            "metrics": [rel("metrics", m["name"] + ".py")
                        for m in cell_metrics(wname, root)["per_layer"]]}


def import_cell(wname: str, root: str = ROOT) -> None:
    """Import every module a run of the cell loads, without running it
    (each driver's `imports()` names the program's and the reference's
    modules it uses)."""
    w = workload(wname, root)
    driver = load("drivers", traffic(w["traffic"], root)["driver"], root)
    driver.imports()
    for m in cell_metrics(wname, root)["per_layer"]:
        load("metrics", m["name"], root)
    importlib.import_module("asrbench.run")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that no run may hold."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def fixed_cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its own kernels into vietasr_tpu_torch/_build/)."""
    cache = os.path.join(root, "asrbench", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def checks_ok(checks: Dict[str, list]) -> bool:
    """Each check is [value, limit]: the value may not pass its limit."""
    return all(v is not None and v <= lim for v, lim in checks.values())
