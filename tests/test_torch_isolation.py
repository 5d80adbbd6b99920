"""vietasr_tpu_torch stands alone: it imports torch, never jax, flax or the
JAX package, and its entry points default to the GPU."""

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "vietasr_tpu_torch")

FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|vietasr_tpu)(\.|\s|$)", re.M)

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import vietasr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vietasr_tpu_torch.__path__,
                                               "vietasr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "vietasr_tpu"))
assert not bad, bad
from vietasr_tpu_torch.utils.device import resolve_device
import torch
if not torch.cuda.is_available():
    try:
        resolve_device(None)
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("device=None did not raise without a GPU")
else:
    assert resolve_device(None).type == "cuda"
print(" ".join(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return env


def test_importing_every_module_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 21
    for beam_tier in ("lm", "device_beam", "fused_beam"):
        assert f"vietasr_tpu_torch.ops.{beam_tier}" in names


def test_no_forbidden_import_in_sources():
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    assert len(sources) >= 23
    for path in sources:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        hit = FORBIDDEN_IMPORT.search(text)
        assert hit is None, f"{path}: {hit.group(0).strip()}"


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    """Without a GPU (here) it exits non-zero and prints no result; alone
    in a directory it does too."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(alone))):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
