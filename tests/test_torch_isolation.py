"""vietasr_tpu_torch stands alone: it imports torch, never jax, flax or the
JAX package, and its entry points default to the GPU."""

import os
import re
import shutil
import subprocess
import sys

import pytest

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
    for training in ("ops.ctc_loss", "ops.fused_ctc", "ops.specaug",
                     "train.loop", "train.optim", "train.schedules",
                     "train.state", "train.checkpoint", "audio.tokenizer",
                     "train.freeze", "audio.dataset", "audio.augment",
                     "audio.manifest", "audio.cleaners", "cli"):
        assert f"vietasr_tpu_torch.{training}" in names
    for parallel in ("parallel", "parallel.mesh", "parallel.distributed",
                     "parallel.tp", "parallel.collectives", "export",
                     "ops.custom_ops"):
        assert f"vietasr_tpu_torch.{parallel}" in names


PARALLEL_AND_EXPORT = r"""
import sys
import torch.distributed as dist
import vietasr_tpu_torch.parallel as parallel
import vietasr_tpu_torch.export
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "vietasr_tpu"))
assert not bad, bad
topo = parallel.initialize_multihost()
assert topo == {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1}, topo
topo = parallel.initialize_multihost("localhost:1", 1, 0)
assert topo["process_count"] == 1
assert not dist.is_initialized()
parallel.sync_all_processes(True)
assert parallel.broadcast_string("x") == "x"
import torch
assert hasattr(torch.ops.vietasr, "repeat_block")
print("ok")
"""


def test_parallel_and_export_alone_and_one_process_is_a_no_op():
    """Importing parallel/ and export.py alone pulls in no JAX module and
    registers the kernels' custom ops; initialize_multihost() for one
    process starts no process group (and, on a machine without a GPU,
    does not ask for one)."""
    out = subprocess.run([sys.executable, "-c", PARALLEL_AND_EXPORT],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


STUDY_TOOL = r"""
import importlib.util, os, sys
spec = importlib.util.spec_from_file_location(
    "synth_lang_run_torch", os.path.join("tools", "synth_lang_run_torch.py"))
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "vietasr_tpu"))
assert not bad, bad
import torch
if not torch.cuda.is_available():
    try:
        tool.main(["--phase", "corpus", "--work-dir", sys.argv[1]])
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("the study ran without CUDA or --device cpu")
    assert not os.listdir(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "vietasr_tpu"))
assert not bad, bad
print("ok")
"""


def test_study_tool_imports_no_jax_and_wants_cuda(tmp_path):
    """tools/synth_lang_run_torch.py, imported and run, loads no JAX,
    flax or JAX-package module, and without --device cpu refuses to run
    (here, without a GPU) before it writes anything."""
    out = subprocess.run([sys.executable, "-c", STUDY_TOOL, str(tmp_path)],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_forbidden_import_in_sources():
    sources = [os.path.join(ROOT, "chip_smoke.py"),
               os.path.join(ROOT, "tools", "synth_lang_run_torch.py")]
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


def test_training_entry_points_default_to_cuda(tmp_path):
    """Trainer, CheckpointManager, the featurizers, the loss, the
    JAX-state converter and the command line without --device: device=None
    means CUDA, and raises without it."""
    import numpy as np
    import torch

    from vietasr_tpu_torch.config import load_config
    from vietasr_tpu_torch.frontend.cuda_frontend import make_fused_featurizer
    from vietasr_tpu_torch.frontend.features import make_featurizer
    from vietasr_tpu_torch.models.convert import train_state_from_jax
    from vietasr_tpu_torch.train import (CheckpointManager, Trainer,
                                         make_optimizer)
    from vietasr_tpu_torch import cli
    from vietasr_tpu_torch.train.loop import make_loss_fn

    config = os.path.join(PORT, "configs", "quartznet12x1_vi.yaml")
    cfg = load_config(config)
    empty = tmp_path / "empty.json"
    empty.write_text("")
    variables = {"params": {"w": np.ones(2, np.float32)}, "batch_stats": {}}
    entry_points = {
        "Trainer": lambda: Trainer(cfg).device,
        "CheckpointManager": lambda: CheckpointManager(str(tmp_path)).device,
        "make_featurizer": lambda: make_featurizer(cfg.featurizer)
        .keywords["dft_matrix"].device,
        "make_fused_featurizer": lambda: make_fused_featurizer(
            cfg.featurizer).keywords["mel_matrix"].device,
        "make_loss_fn": lambda: make_loss_fn(cfg) and torch.device("cuda"),
        "train_state_from_jax": lambda: train_state_from_jax(
            variables, optimizer=make_optimizer("sgd", 0.1)).step.device,
        "cli": lambda: cli.main(["eval", "--config", config, "--manifest",
                                 str(empty)]) or torch.device("cuda"),
    }
    for name, call in entry_points.items():
        if torch.cuda.is_available():
            assert call().type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


NATIVE_ONLY_OWN = r"""
import numpy as np
from vietasr_tpu_torch.ops.beam_search import BeamSearchDecoderLM
dec = BeamSearchDecoderLM(["a", "b", " "], beam_width=4)
lp = np.log(np.full((5, 4), 0.25, np.float32))
dec.decode(lp)
maps = open("/proc/self/maps").read()
libs = sorted({l.split()[-1] for l in maps.splitlines() if ".so" in l})
own = [l for l in libs if "vietasr_tpu_torch/_build/ctcbeam-" in l]
assert len(own) == 1, libs
assert not any("libctcbeam" in l for l in libs), libs
import sys
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "vietasr_tpu"))
assert not bad, bad
"""


@pytest.mark.skipif(not os.path.exists("/proc/self/maps"),
                    reason="needs /proc/self/maps (Linux)")
def test_host_beam_loads_only_its_own_native_library():
    """The host beam tier builds and loads the port's own library from
    vietasr_tpu_torch/native/ctc_beam.cc, never the JAX package's
    libctcbeam.so, and pulls in no JAX."""
    out = subprocess.run([sys.executable, "-c", NATIVE_ONLY_OWN], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
