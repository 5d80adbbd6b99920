"""Fused CTC prefix beam search: the whole decode over T as one CUDA kernel
launch (csrc/beam_search.cu), with its plain PyTorch version beside it.

Counterpart of vietasr_tpu/ops/pallas_beam.py::pallas_beam_search (the
Pallas `_beam_kernel`). Contract: the same output as `device_beam_search`
with canonical (space-normalised) beam identity, `cutoff_top_n > 0`, no
char-LM table, W <= 128 and an optional word LM of order <= 5. The
kernel keeps `device_beam_search`'s slot order (its top-W select ranks
the candidates above a threshold in a total order: value descending, then
candidate index ascending), so its raw result, final packed state and
(parent, char) backpointers, matches the plain version slot by slot. Rows
are independent, so one launch takes every utterance of a call, each
stopping at its own length.

What runs where, as in the JAX package: the per-frame top-K is a PyTorch
sort before the kernel; the final ranking with the trailing partial word,
the argmax and the backtrace are PyTorch after it.

`fused_beam_search` launches the kernel for CUDA tensors (launches counted
in `fused_beam_search.launches`) and takes the plain version only for CPU
tensors; `beam_search_cuda` is the launch itself. The same route is the
custom op `vietasr::beam_search` (ops/custom_ops.py), which the wrapper
calls while an export traces.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import torch

from vietasr_tpu_torch import _build
from vietasr_tpu_torch.ops import custom_ops
from vietasr_tpu_torch.ops.device_beam import (KERNEL_MAX_BEAM_WIDTH,
                                               WordLMTables,
                                               best_path_from_raw,
                                               device_beam_search,
                                               expansion_width, frame_topk,
                                               init_packed_state,
                                               packed_state_cols)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("beam_search")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vt_beam_search.argtypes = [p] * 13 + [i] * 12 + [f, f, p]
    lib.vt_beam_search.restype = i
    lib.vt_beam_smem_bytes.argtypes = [i] * 6
    lib.vt_beam_smem_bytes.restype = ctypes.c_longlong
    return lib


def _need(name: str, tsr: torch.Tensor, device, dtype, shape) -> None:
    if tsr.device != device:
        raise ValueError(f"beam kernel: {name} must be on {device}, "
                         f"got {tsr.device}")
    if tsr.dtype != dtype or not tsr.is_contiguous():
        raise ValueError(f"beam kernel: {name} must be contiguous {dtype}, "
                         f"got {tsr.dtype}")
    if tuple(tsr.shape) != tuple(shape):
        raise ValueError(f"beam kernel: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(tsr.shape)}")


def beam_search_cuda(log_probs: torch.Tensor, lengths: torch.Tensor,
                     top_lp: torch.Tensor, top_ci: torch.Tensor,
                     state: torch.Tensor, *, blank: int, space: int,
                     alpha: float = 0.5, beta: float = 0.0,
                     word_lm: Optional[WordLMTables] = None,
                     wlm_probes: int = 8,
                     stats: Optional[torch.Tensor] = None):
    """The kernel: CUDA tensors only, one launch.

    log_probs (B, T, V+1) f32, lengths (B,) int32, the frame's top-K
    top_lp (B, T, K) f32 / top_ci (B, T, K) int32, the packed start state
    (B, W, n_cols) int32, word_lm in its tensor form. Returns
    (final_state (B, W, n_cols) int32, parents (T, B, W) int32,
    chars (T, B, W) int32), as device_beam_search(return_raw=True).
    `stats`, a (B, 2) int64 tensor, receives per row the block-wide
    barriers its steps took and the keys >= the select's threshold they
    ranked."""
    dev = log_probs.device
    if dev.type != "cuda":
        raise ValueError(f"beam kernel: log_probs must be a CUDA tensor, "
                         f"got {dev}")
    if log_probs.ndim != 3:
        raise ValueError("beam kernel: log_probs must be (B, T, V+1)")
    bsz, t_max, v1 = log_probs.shape
    if state.ndim != 3 or top_lp.ndim != 3:
        raise ValueError("beam kernel: state must be (B, W, n_cols) and "
                         "top_lp (B, T, K)")
    w, k_c = state.shape[1], top_lp.shape[2]
    if not 1 <= w <= KERNEL_MAX_BEAM_WIDTH:
        raise ValueError(f"beam kernel: beam width {w} outside [1, "
                         f"{KERNEL_MAX_BEAM_WIDTH}]")
    if t_max >= 1 << 23:
        raise ValueError(f"beam kernel: T = {t_max} frames >= 2^23")
    if not 1 <= k_c < v1 or not 0 <= space < v1 - 1 or blank != v1 - 1:
        raise ValueError("beam kernel: needs 1 <= K <= V, 0 <= space < V "
                         "and blank == V")
    levels = int(word_lm.masks.shape[0]) if word_lm is not None else 0
    n_cols = packed_state_cols(word_lm)
    _need("log_probs", log_probs, dev, torch.float32, (bsz, t_max, v1))
    _need("lengths", lengths, dev, torch.int32, (bsz,))
    _need("top_lp", top_lp, dev, torch.float32, (bsz, t_max, k_c))
    _need("top_ci", top_ci, dev, torch.int32, (bsz, t_max, k_c))
    _need("state", state, dev, torch.int32, (bsz, w, n_cols))
    if stats is not None:
        _need("stats", stats, dev, torch.int64, (bsz, 2))
    lm_ptrs = [None, None, None, None]
    lm_rows = 0
    if word_lm is not None:
        lm_rows = int(word_lm.packed.shape[0])
        _need("word_lm.packed", word_lm.packed, dev, torch.int32,
              (word_lm.packed.shape[0], 4))
        _need("word_lm.masks", word_lm.masks, dev, torch.int64, (levels,))
        _need("word_lm.bases", word_lm.bases, dev, torch.int64, (levels,))
        _need("word_lm.unk_logp", word_lm.unk_logp, dev, torch.float32, ())
        lm_ptrs = [word_lm.packed.data_ptr(), word_lm.masks.data_ptr(),
                   word_lm.bases.data_ptr(), word_lm.unk_logp.data_ptr()]
    lib = _lib()
    smem = lib.vt_beam_smem_bytes(w, k_c, v1, n_cols, levels, lm_rows)
    if smem <= 0 or smem > _build.SMEM_LIMIT:
        raise ValueError(f"beam kernel: {smem} B of shared memory for "
                         f"W={w}, K={k_c}, V+1={v1} exceeds "
                         f"{_build.SMEM_LIMIT}")
    out_state = torch.empty_like(state)
    parents = torch.empty((t_max, bsz, w), dtype=torch.int32, device=dev)
    chars = torch.empty((t_max, bsz, w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.vt_beam_search(
            log_probs.data_ptr(), lengths.data_ptr(), top_lp.data_ptr(),
            top_ci.data_ptr(), state.data_ptr(), *lm_ptrs,
            out_state.data_ptr(), parents.data_ptr(), chars.data_ptr(),
            None if stats is None else stats.data_ptr(), bsz, t_max, v1,
            k_c, w, n_cols, blank, space, levels, int(wlm_probes), lm_rows, int(smem), alpha, beta, stream)
    _build.check(lib, err, "beam kernel")
    fused_beam_search.launches += 1
    return out_state, parents, chars


@torch.inference_mode()
def fused_beam_search(log_probs: torch.Tensor, lengths: torch.Tensor, *,
                      blank: int, beam_width: int = 16,
                      cutoff_top_n: int = 8,
                      word_lm: Optional[WordLMTables] = None,
                      wlm_probes: int = 8, alpha: float = 0.5,
                      beta: float = 0.0, space: int = -1, max_len: int = 0,
                      carry_state: Optional[torch.Tensor] = None,
                      return_raw: bool = False):
    """(B, T, V+1) log-probs -> (prefixes (B, L), lens (B,)) int32.

    CUDA tensors go through the kernel; CPU tensors through its plain
    version, device_beam_search. `carry_state` resumes every row from a
    packed (B, W, n_cols) state (a streaming search carried across
    chunks) in place of the fresh one. `return_raw=True` returns the raw
    (final_state, parents, chars) instead, for comparing the two."""
    if space < 0:
        raise ValueError("fused_beam_search requires the space label id")
    if cutoff_top_n <= 0:
        raise ValueError("fused_beam_search requires cutoff_top_n > 0")
    if beam_width > KERNEL_MAX_BEAM_WIDTH:
        raise ValueError(f"fused_beam_search takes beam_width <= "
                         f"{KERNEL_MAX_BEAM_WIDTH}, got {beam_width}")
    state = init_packed_state(log_probs.shape[0], beam_width, word_lm,
                              log_probs.device) \
        if carry_state is None else carry_state.contiguous()
    route = torch.ops.vietasr.beam_search if custom_ops.active() \
        else _route
    raw = route(log_probs, lengths, state,
                [] if word_lm is None else list(word_lm), blank, space,
                float(alpha), float(beta), cutoff_top_n, wlm_probes)
    if return_raw:
        return raw
    return best_path_from_raw(*raw, word_lm=word_lm, alpha=alpha, beta=beta,
                              wlm_probes=wlm_probes,
                              l_max=max_len or log_probs.shape[1])


fused_beam_search.launches = 0


def _route(log_probs, lengths, state, word_lm: List[torch.Tensor],
           blank: int, space: int, alpha: float, beta: float,
           cutoff_top_n: int, wlm_probes: int):
    """The raw search from the packed `state`: the kernel for CUDA
    tensors, its plain version device_beam_search for CPU tensors."""
    lm = WordLMTables(*word_lm) if word_lm else None
    if log_probs.device.type == "cpu":
        return device_beam_search(
            log_probs, lengths, beam_width=state.shape[1], blank=blank,
            alpha=alpha, beta=beta, cutoff_top_n=cutoff_top_n, word_lm=lm,
            wlm_probes=wlm_probes, space=space, carry_state=state,
            return_raw=True)
    top_lp, top_ci = frame_topk(log_probs,
                                expansion_width(log_probs.shape[2] - 1,
                                                cutoff_top_n))
    return beam_search_cuda(
        log_probs, lengths.to(torch.int32).contiguous(), top_lp.contiguous(),
        top_ci.contiguous(), state, blank=blank, space=space, alpha=alpha,
        beta=beta, word_lm=lm, wlm_probes=wlm_probes)


_beam_op = torch.library.custom_op(
    "vietasr::beam_search", _route, mutates_args=(),
    schema="(Tensor log_probs, Tensor lengths, Tensor state, "
           "Tensor[] word_lm, int blank, int space, float alpha, "
           "float beta, int cutoff_top_n, int wlm_probes) "
           "-> (Tensor, Tensor, Tensor)")


@_beam_op.register_fake
def _(log_probs, lengths, state, word_lm, blank, space, alpha, beta,
      cutoff_top_n, wlm_probes):
    bsz, t_max = log_probs.shape[:2]
    w = state.shape[1]
    return (torch.empty_like(state),
            state.new_empty((t_max, bsz, w)), state.new_empty((t_max, bsz, w)))
