"""What a run loads holds no module of JAX or of the JAX package: each
cell's modules are imported in a fresh interpreter and every top-level
module name is compared whole (the port's name begins with the JAX
package's)."""

import json
import subprocess
import sys

import pytest

from asrbench import core

CELLS = [w["name"] for w in core.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_imports_no_jax(workload):
    code = ("import json, sys; sys.path.insert(0, %r); "
            "from asrbench import core; core.import_cell(%r); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (core.ROOT, workload))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "vietasr_tpu_torch" in tops       # the program was imported
    assert not tops & set(core.FORBIDDEN), tops & set(core.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vietasr_tpu_torch_fake", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vietasr_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert core.forbidden_modules() == ["jaxlib", "vietasr_tpu"]
