"""The CTC alpha/beta kernel pair (csrc/ctc.cu) behind a
`torch.autograd.Function`, with its plain PyTorch version beside it.

Counterpart of vietasr_tpu/ops/pallas_ctc.py (`_fwd_kernel`,
`_bwd_kernel` and the custom-VJP `_ctc_ll`). The forward kernel emits the
whole alpha lattice; the log-likelihood is read from its last row
(`final_ll`, plain PyTorch, as in JAX). The backward kernel runs the beta
suffix recursion from each row's own last valid frame and gives the
analytic gradient

    d ll_b / d lp_ext[b, t, s] = ybar_b * exp(min(alpha + beta - ll_b, 0))

masked to 0 past the input length, off the valid lattice and on infeasible
rows (ll <= NEG / 2). The loss is -ll: `ctc_neg_ll` negates outside the
Function, so autograd carries the sign.

Layout: the lattice is (B, T, S), S = 2L + 1, unpadded (JAX pads B to 8 and
S to 128 only for the TPU's tiling, and lays it out as (T, B, S)).

`fused_ctc_alpha` / `fused_ctc_beta` launch the kernels for CUDA tensors
(launches counted in their `.launches`) and take the plain versions
(`ctc_alpha_plain`, `ctc_beta_plain`) only for CPU tensors;
`ctc_alpha_cuda` / `ctc_beta_cuda` are the launches themselves, under the
`launch_plan` for the lattice width and the card's shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vietasr_tpu_torch import _build

NEG = -1e30


def lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b + e^c) with the NEG sentinel: NEG where the max is
    <= NEG / 2 (the Pallas `_lse3`); the exponentials summed left to right."""
    m = torch.maximum(a, torch.maximum(b, c))
    s = m + torch.log((torch.exp(a - m) + torch.exp(b - m))
                      + torch.exp(c - m))
    return torch.where(m <= NEG / 2, torch.full_like(s, NEG), s)


def final_ll(alpha_last: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
    """(B,) log-likelihood from the last (frozen) alpha row: the lse of the
    end states 2*tlen and 2*tlen - 1 (the latter absent when tlen == 0),
    NEG for an infeasible row (the Pallas `_final_ll`)."""
    tl = tlen.to(torch.int64)
    end_blank = alpha_last.gather(1, (2 * tl)[:, None])[:, 0]
    idx = torch.clamp_min(2 * tl - 1, 0)
    end_label = alpha_last.gather(1, idx[:, None])[:, 0]
    end_label = torch.where(tl > 0, end_label, torch.full_like(end_label, NEG))
    m = torch.maximum(end_blank, end_label)
    ll = m + torch.log(torch.exp(end_blank - m) + torch.exp(end_label - m))
    return torch.where(m <= NEG / 2, torch.full_like(ll, NEG), ll)


# ---------------------------------------------------------------------------
# plain versions


def ctc_alpha_plain(lp_ext: torch.Tensor, can: torch.Tensor,
                    valid: torch.Tensor, ilen: torch.Tensor) -> torch.Tensor:
    """The forward kernel's plain version: (B, T, S) alpha lattice, a loop
    over T with the per-row input-length freeze."""
    bsz, t_max, s = lp_ext.shape
    pos = torch.arange(s, device=lp_ext.device)[None, :]
    neg = torch.full((bsz, s), NEG, dtype=lp_ext.dtype, device=lp_ext.device)
    a = torch.where((pos <= 1) & valid, lp_ext[:, 0], neg)
    rows = [a]
    for t in range(1, t_max):
        a1 = F.pad(a, (1, 0), value=NEG)[:, :s]
        a2 = torch.where(can, F.pad(a, (2, 0), value=NEG)[:, :s], neg)
        new = torch.where(valid, lse3(a, a1, a2) + lp_ext[:, t], neg)
        a = torch.where((t < ilen)[:, None], new, a)
        rows.append(a)
    return torch.stack(rows, dim=1)


def ctc_beta_plain(lp_ext: torch.Tensor, alphas: torch.Tensor,
                   can: torch.Tensor, valid: torch.Tensor, ilen: torch.Tensor,
                   tlen: torch.Tensor, ll: torch.Tensor, ybar: torch.Tensor
                   ) -> torch.Tensor:
    """The backward kernel's plain version: (B, T, S) d ll / d lp_ext, the
    beta recursion over every frame from T - 1 down, as the Pallas kernel
    runs it."""
    bsz, t_max, s = lp_ext.shape
    pos = torch.arange(s, device=lp_ext.device)[None, :]
    neg = torch.full((bsz, s), NEG, dtype=lp_ext.dtype, device=lp_ext.device)
    can2 = F.pad(can, (0, 2))[:, 2:]          # departure gate: can[s + 2]
    tl = tlen[:, None]
    init_end = torch.where((pos == 2 * tl) | ((tl > 0) & (pos == 2 * tl - 1)),
                           torch.zeros_like(neg), neg)
    keep = valid & (ll > NEG / 2)[:, None]
    g = torch.empty_like(lp_ext)
    q = neg
    for t in range(t_max - 1, -1, -1):
        q1 = F.pad(q, (0, 1), value=NEG)[:, 1:]
        q2 = torch.where(can2, F.pad(q, (0, 2), value=NEG)[:, 2:], neg)
        beta = torch.where((t >= ilen - 1)[:, None], init_end,
                           lse3(q, q1, q2))
        gt = ybar[:, None] * torch.exp(torch.minimum(
            alphas[:, t] + beta - ll[:, None], torch.zeros_like(beta)))
        g[:, t] = torch.where(keep & (t < ilen)[:, None], gt,
                              torch.zeros_like(gt))
        q = torch.where(valid, beta + lp_ext[:, t], neg)
    return g


# ---------------------------------------------------------------------------
# the kernels


# launch plans: lattice positions per thread, and prefetch ring depths, that
# csrc/ctc.cu is built for, and the most threads a block takes
PLAN_ITEMS = (1, 2, 4)
PLAN_RINGS = (2, 4, 8, 16)
PLAN_MAX_THREADS = 1024


class CTCPlan(NamedTuple):
    """One kernel launch's shape: each of `threads` threads owns `items`
    consecutive lattice positions and prefetches its own positions of the
    next `ring` frames into shared memory (`smem` bytes with the warp-edge
    exchange)."""
    items: int
    threads: int
    ring: int
    smem: int


def plan_smem(streams: int, items: int, threads: int, ring: int) -> int:
    """Shared memory of a launch (csrc/ctc.cu::smem_bytes): `streams` rings
    (lp_ext, and alphas going back) of `ring` rows of threads * items
    floats, then 2 parities x (warps + 1) slots x 2 floats of warp edges."""
    return 4 * (streams * ring * threads * items + 2 * (threads // 32 + 1) * 2)


def launch_plan(s: int, streams: int, smem_limit: int = _build.SMEM_LIMIT
                ) -> CTCPlan:
    """The plan for lattice width `s`: the fewest positions per thread
    within PLAN_MAX_THREADS threads (ptxas runs a thread's cells one after
    another, while the SM's four schedulers interleave warps), the fewest
    warps that cover the row, and the deepest built ring whose `streams`
    rings fit `smem_limit` bytes (alpha has 1 stream, beta 2)."""
    if not 1 <= s <= PLAN_MAX_THREADS * PLAN_ITEMS[-1]:
        raise ValueError(f"ctc kernel: no launch plan for S = {s}")
    items = next(k for k in PLAN_ITEMS if -(-s // k) <= PLAN_MAX_THREADS)
    threads = -(-s // (32 * items)) * 32
    for ring in sorted(PLAN_RINGS, reverse=True):
        smem = plan_smem(streams, items, threads, ring)
        if smem <= smem_limit:
            return CTCPlan(items, threads, ring, smem)
    raise ValueError(f"ctc kernel: S = {s} needs more than {smem_limit} "
                     "bytes of shared memory")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ctc")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vt_ctc_alpha.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.vt_ctc_alpha.restype = i
    lib.vt_ctc_beta_grad.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.vt_ctc_beta_grad.restype = i
    lib.vt_ctc_max_s.argtypes = []
    lib.vt_ctc_max_s.restype = i
    lib.vt_ctc_smem_limit.argtypes = []
    lib.vt_ctc_smem_limit.restype = i
    lib.vt_ctc_math.argtypes = [p] * 3 + [ctypes.c_longlong, p]
    lib.vt_ctc_math.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """Shared memory one block may use on CUDA device `index`."""
    with torch.cuda.device(index):
        limit = _lib().vt_ctc_smem_limit()
    if limit <= 0:
        raise RuntimeError("ctc kernel: cannot read the device's shared "
                           "memory limit")
    return limit


def device_plan(s: int, streams: int, device: torch.device) -> CTCPlan:
    """`launch_plan` for lattice width `s` on CUDA device `device`."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return launch_plan(s, streams, _smem_limit(index))


def _need(name: str, tsr: torch.Tensor, device, dtype, shape) -> None:
    if tsr.device != device:
        raise ValueError(f"ctc kernel: {name} must be on {device}, "
                         f"got {tsr.device}")
    if tsr.dtype != dtype or not tsr.is_contiguous():
        raise ValueError(f"ctc kernel: {name} must be contiguous {dtype}, "
                         f"got {tsr.dtype}")
    if tuple(tsr.shape) != tuple(shape):
        raise ValueError(f"ctc kernel: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(tsr.shape)}")


def _lattice_shape(lp_ext: torch.Tensor):
    if lp_ext.device.type != "cuda":
        raise ValueError(f"ctc kernel: lp_ext must be a CUDA tensor, got "
                         f"{lp_ext.device}")
    if lp_ext.ndim != 3 or 0 in lp_ext.shape:
        raise ValueError("ctc kernel: lp_ext must be a non-empty (B, T, S)")
    bsz, t_max, s = lp_ext.shape
    max_s = _lib().vt_ctc_max_s()
    if s > max_s:
        raise ValueError(f"ctc kernel: lattice width S = {s} exceeds "
                         f"{max_s} (target length > {(max_s - 1) // 2})")
    return bsz, t_max, s


def ctc_alpha_cuda(lp_ext: torch.Tensor, can: torch.Tensor,
                   valid: torch.Tensor, ilen: torch.Tensor, *,
                   plan: CTCPlan | None = None) -> torch.Tensor:
    """The forward kernel, one launch: lp_ext (B, T, S) fp32, can / valid
    (B, S) bool, ilen (B,) int32, all contiguous on one GPU -> alphas.
    `plan` overrides `device_plan(S, 1, device)`."""
    bsz, t_max, s = _lattice_shape(lp_ext)
    dev = lp_ext.device
    _need("lp_ext", lp_ext, dev, torch.float32, (bsz, t_max, s))
    _need("can", can, dev, torch.bool, (bsz, s))
    _need("valid", valid, dev, torch.bool, (bsz, s))
    _need("ilen", ilen, dev, torch.int32, (bsz,))
    plan = plan or device_plan(s, 1, dev)
    alphas = torch.empty_like(lp_ext)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vt_ctc_alpha(
            lp_ext.data_ptr(), can.data_ptr(), valid.data_ptr(),
            ilen.data_ptr(), alphas.data_ptr(), bsz, t_max, s, plan.items,
            plan.threads, plan.ring,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ctc alpha kernel")
    fused_ctc_alpha.launches += 1
    return alphas


def ctc_beta_cuda(lp_ext: torch.Tensor, alphas: torch.Tensor,
                  can: torch.Tensor, valid: torch.Tensor, ilen: torch.Tensor,
                  tlen: torch.Tensor, ll: torch.Tensor, ybar: torch.Tensor, *,
                  plan: CTCPlan | None = None) -> torch.Tensor:
    """The backward kernel, one launch: lp_ext / alphas (B, T, S) fp32,
    can / valid (B, S) bool, ilen / tlen (B,) int32, ll / ybar (B,) fp32,
    all contiguous on one GPU -> d ll / d lp_ext (B, T, S) fp32. `plan`
    overrides `device_plan(S, 2, device)`."""
    bsz, t_max, s = _lattice_shape(lp_ext)
    dev = lp_ext.device
    _need("lp_ext", lp_ext, dev, torch.float32, (bsz, t_max, s))
    _need("alphas", alphas, dev, torch.float32, (bsz, t_max, s))
    _need("can", can, dev, torch.bool, (bsz, s))
    _need("valid", valid, dev, torch.bool, (bsz, s))
    for name, x, dtype in (("ilen", ilen, torch.int32),
                           ("tlen", tlen, torch.int32),
                           ("ll", ll, torch.float32),
                           ("ybar", ybar, torch.float32)):
        _need(name, x, dev, dtype, (bsz,))
    plan = plan or device_plan(s, 2, dev)
    grad = torch.empty_like(lp_ext)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vt_ctc_beta_grad(
            lp_ext.data_ptr(), alphas.data_ptr(), can.data_ptr(),
            valid.data_ptr(), ilen.data_ptr(), tlen.data_ptr(), ll.data_ptr(),
            ybar.data_ptr(), grad.data_ptr(), bsz, t_max, s, plan.items,
            plan.threads, plan.ring,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "ctc beta kernel")
    fused_ctc_beta.launches += 1
    return grad


def kernel_math_cuda(x: torch.Tensor) -> tuple:
    """(exp(x), log(x)) of a contiguous fp32 CUDA tensor through the
    kernels' own exp and log (csrc/ctc.cu::exp_n, log_n), which repeat CUDA's
    expf and logf operation for operation (log for finite x >= 1 only): the
    test that holds them to torch.exp and torch.log."""
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("ctc kernel math: x must be a non-empty contiguous "
                         "fp32 CUDA tensor")
    ex, lg = torch.empty_like(x), torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.vt_ctc_math(x.data_ptr(), ex.data_ptr(), lg.data_ptr(),
                              x.numel(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "ctc kernel math")
    return ex, lg


def fused_ctc_alpha(lp_ext, can, valid, ilen) -> torch.Tensor:
    """Alpha lattice: the kernel for CUDA tensors, its plain version for
    CPU tensors."""
    fn = ctc_alpha_plain if lp_ext.device.type == "cpu" else ctc_alpha_cuda
    return fn(lp_ext, can, valid, ilen)


fused_ctc_alpha.launches = 0


def fused_ctc_beta(lp_ext, alphas, can, valid, ilen, tlen, ll, ybar
                   ) -> torch.Tensor:
    """d ll / d lp_ext: the kernel for CUDA tensors, its plain version for
    CPU tensors."""
    fn = ctc_beta_plain if lp_ext.device.type == "cpu" else ctc_beta_cuda
    return fn(lp_ext, alphas, can, valid, ilen, tlen, ll, ybar)


fused_ctc_beta.launches = 0


class CTCLogLikelihood(torch.autograd.Function):
    """(B, T, S) lp_ext -> (B,) ll, differentiable in lp_ext only.

    `plain=True` runs the plain versions on any device (the kernel's
    yardstick); otherwise the kernels for CUDA tensors, the plain versions
    for CPU tensors."""

    @staticmethod
    def forward(ctx, lp_ext, can, valid, ilen, tlen, plain: bool):
        alpha_fn = ctc_alpha_plain if plain else fused_ctc_alpha
        alphas = alpha_fn(lp_ext, can, valid, ilen)
        ll = final_ll(alphas[:, -1], tlen)
        ctx.plain = plain
        ctx.save_for_backward(lp_ext, alphas, can, valid, ilen, tlen, ll)
        return ll

    @staticmethod
    def backward(ctx, ybar):
        beta_fn = ctc_beta_plain if ctx.plain else fused_ctc_beta
        g = beta_fn(*ctx.saved_tensors, ybar.to(torch.float32).contiguous())
        return g, None, None, None, None, None


def ctc_neg_ll(lp_ext: torch.Tensor, can_skip: torch.Tensor,
               valid_s: torch.Tensor, input_lengths: torch.Tensor,
               target_lengths: torch.Tensor, *, plain: bool = False
               ) -> torch.Tensor:
    """Kernel-pair negative log-likelihood (counterpart of
    `ctc_neg_ll_pallas`).

    lp_ext: (B, T, S) label log-probs on the extended lattice (looked up
    from (B, T, V) outside); can_skip: (B, S) bool, arrival at s from s-2
    allowed; valid_s: (B, S) bool, s < 2 * target_len + 1; input_lengths,
    target_lengths: (B,) int. Returns (B,) -log p, differentiable in lp_ext.
    `plain=True` takes the plain versions on any device."""
    ll = CTCLogLikelihood.apply(
        lp_ext.to(torch.float32).contiguous(),
        can_skip.to(torch.bool).contiguous(),
        valid_s.to(torch.bool).contiguous(),
        input_lengths.to(torch.int32).contiguous(),
        target_lengths.to(torch.int32).contiguous(), plain)
    return -ll
