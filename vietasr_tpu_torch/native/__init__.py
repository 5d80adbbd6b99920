"""The host beam tier's native library (the port's copy of
vietasr_tpu/native/__init__.py), loaded via ctypes.

`ctc_beam.cc` (an ARPA LM and the CTC prefix beam search in C++) is
compiled by the host C++ compiler at first use into
`vietasr_tpu_torch/_build/ctcbeam-<hash>.so`, where the hash covers the
source and the flags, so an edited source builds anew and an unchanged one
is reused. The library is written under a temporary name and moved into
place, so several processes may build it at once. A failed build raises
with the compiler's output: the port has no silent fallback to the Python
tier (`BeamSearchDecoderLM(use_native=False)` asks for that tier).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ctc_beam.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def lib_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ctcbeam-{h.hexdigest()[:16]}.so")


def build_native(force: bool = False) -> str:
    """Compile the shared library if it is missing (or `force`); returns
    its path. Raises RuntimeError with g++'s output if the build fails."""
    out = lib_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"native beam build failed: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native beam build failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    path = build_native()
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.vba_lm_load.restype = ctypes.c_void_p
        lib.vba_lm_load.argtypes = [ctypes.c_char_p]
        lib.vba_lm_free.argtypes = [ctypes.c_void_p]
        lib.vba_lm_order.restype = ctypes.c_int
        lib.vba_lm_order.argtypes = [ctypes.c_void_p]
        lib.vba_lm_logp.restype = ctypes.c_float
        lib.vba_lm_logp.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p]
        lib.vba_beam_decode.restype = ctypes.c_int
        lib.vba_beam_decode.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_float,
            ctypes.c_char_p, ctypes.c_int,
        ]
        _libs[path] = lib
    return lib


class NativeLM:
    """ctypes handle over the C++ ARPA LM. The C++ side reads the whole
    file while loading, so the file may go once this returns."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.vba_lm_load(path.encode())
        if not self._h:
            raise IOError(f"failed to load ARPA LM: {path}")

    @property
    def order(self) -> int:
        return self._lib.vba_lm_order(self._h)

    def log_prob(self, word: str, context: Sequence[str] = ()) -> float:
        return float(self._lib.vba_lm_logp(
            self._h, word.encode(), " ".join(context).encode()))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vba_lm_free(self._h)
            self._h = None


class CtcBeamNative:
    """Native CTC prefix beam search with optional LM fusion. The defaults
    are the reference's (cutoff_top_n=40 vocabulary pruning,
    beam_search_decoder.py:34-36)."""

    def __init__(self, labels: Sequence[str], *, lm_path: Optional[str] = None,
                 alpha: float = 0.5, beta: float = 1.5,
                 token_min_logp: float = -10.0, cutoff_top_n: int = 40,
                 beam_prune_logp: float = -20.0):
        self._lib = _load()
        self.labels = list(labels)
        self.alpha = alpha
        self.beta = beta
        self.token_min_logp = token_min_logp
        self.cutoff_top_n = cutoff_top_n
        self.beam_prune_logp = beam_prune_logp
        # the UTF-8 label bytes and the char* array over them live as long
        # as the decoder: the C side reads them on every decode
        self._label_bytes = [l.encode() for l in self.labels]
        self._label_arr = (ctypes.c_char_p * len(self._label_bytes))(
            *self._label_bytes)
        self._lm = NativeLM(lm_path) if lm_path else None

    def decode(self, log_probs: np.ndarray, beam_width: int = 100) -> str:
        lp = np.ascontiguousarray(log_probs, np.float32)
        t, v = lp.shape
        if v != len(self.labels) + 1:
            raise ValueError(f"log_probs has {v} columns, want "
                             f"{len(self.labels) + 1} (blank last)")
        # a frame emits at most one label of at most 4 UTF-8 bytes
        out = ctypes.create_string_buffer(4 * t + 16)
        n = self._lib.vba_beam_decode(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v,
            self._label_arr, len(self.labels),
            self._lm._h if self._lm else None,
            self.alpha, self.beta, beam_width, self.token_min_logp,
            self.cutoff_top_n, self.beam_prune_logp,
            out, len(out))
        if n < 0:
            raise RuntimeError("beam decode output overflow")
        return out.value.decode("utf-8")

    def decode_batch(self, log_probs: np.ndarray, lengths: np.ndarray,
                     beam_width: int = 100) -> List[str]:
        return [self.decode(log_probs[i, : int(lengths[i])], beam_width)
                for i in range(log_probs.shape[0])]
