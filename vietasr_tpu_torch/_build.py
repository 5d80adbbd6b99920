"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers) and is
compiled on its own into `_build/<name>-<hash>.so`, where the hash covers
the source, the headers beside it (`csrc/*.cuh`) and the flags, so an
edited source or header builds anew and an unchanged one is reused. Sources build in parallel, one nvcc each.
Pointers and the CUDA stream cross the boundary as `c_void_p`; every C
entry returns `cudaGetLastError()` after its launch.

The build needs nvcc (the CUDA toolkit) and an sm_90a card to run on;
nothing here is imported or built until a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("frontend", "frontend_fast", "repeat_block", "beam_search",
           "ctc")
SMEM_LIMIT = 232448    # bytes of shared memory one H100 block may use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ with it")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def lib_path(name: str) -> str:
    """The library of csrc/<name>.cu, named by a hash of the source, every
    header beside it (csrc/*.cuh, which a source may include) and the
    flags: an edited header builds anew too."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f)
                                       for f in headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES, *, ptxas_verbose: bool = False
          ) -> Dict[str, dict]:
    """Compile every named source whose library is missing, all nvcc
    processes at once. Returns {name: {"seconds", "log"}} for the ones
    built. Raises RuntimeError with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done: Dict[str, dict] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        fn = lib.vt_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {err} ({fn(err).decode()}) at launch")
