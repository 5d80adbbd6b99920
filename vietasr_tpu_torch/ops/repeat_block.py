"""Fused QuartzNet repeat block: R x (depthwise + pointwise + folded BN +
ReLU) + residual, as one CUDA kernel launch per repeat
(csrc/repeat_block.cu), with a plain PyTorch version beside it.

Counterpart of vietasr_tpu/ops/pallas_repeat.py::fused_repeat_block, with
the same contract and the numerics of its Pallas `_kernel`: the depthwise
runs in fp32 over fp32 weights with rows outside [0, len) masked before
and after it; its result is cast to bf16 for the 1x1 product with fp32
accumulation; biases are fp32; ReLU between repeats; the residual is the
masked block input through its own bf16 1x1 product plus bias; the sum
goes through a final ReLU and is stored in x's dtype. Rows beyond len come
out as relu(b_pw + b_res), as in JAX; later blocks mask them.

`fused_repeat_block` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; `fused_repeat_block_plain` is the
plain version on any device (the reference the kernel is held to). The
same route is the custom op `vietasr::repeat_block` (ops/custom_ops.py),
which the wrapper calls while an export traces.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from vietasr_tpu_torch import _build
from vietasr_tpu_torch.ops import custom_ops


def fused_repeat_block_plain(
    x: torch.Tensor,                    # (B, T, C_in)
    lens: torch.Tensor,                 # (B,) int
    dw_ws: Sequence[torch.Tensor],      # R x (K, C_r)  (C_0 = C_in, else C_out)
    pw_ws: Sequence[torch.Tensor],      # R x (C_r, C_out)
    bs: Sequence[torch.Tensor],         # R x (C_out,)
    res_w: Optional[torch.Tensor],      # (C_in, C_out) or None
    res_b: Optional[torch.Tensor],      # (C_out,) or None
    *,
    kernel: int,
    last_act: bool = False,
) -> torch.Tensor:
    """Plain version of the kernel (any device)."""
    t = x.shape[1]
    mask = (torch.arange(t, device=x.device)[None, :]
            < lens[:, None])[:, :, None]                        # (B, T, 1)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    cur = x.to(torch.float32)
    r = len(dw_ws)
    for i in range(r):
        cur = torch.where(mask, cur, zero)
        w = dw_ws[i].to(torch.float32)                          # (K, C)
        y = F.conv1d(cur.transpose(1, 2), w.t().unsqueeze(1),
                     padding=kernel // 2, groups=w.shape[1]).transpose(1, 2)
        y = torch.where(mask, y, zero)
        z = bf16_matmul(y, pw_ws[i]) + bs[i].to(torch.float32)
        if i < r - 1 or last_act:
            z = torch.relu(z)
        cur = z
    if res_w is not None:
        center = torch.where(mask, x.to(torch.float32), zero)
        cur = cur + (bf16_matmul(center, res_w) + res_b.to(torch.float32))
    return torch.relu(cur).to(x.dtype)


def bf16_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 accumulation and result. The product of two bf16
    values is exact in fp32, so an fp32 matmul of the rounded operands is
    the bf16 GEMM with fp32 accumulation on any device (callers on the GPU
    keep TF32 off, PyTorch's default for matmuls)."""
    return torch.matmul(a.to(torch.bfloat16).to(torch.float32),
                        w.to(torch.bfloat16).to(torch.float32))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("repeat_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vt_repeat_forward.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i,
                                      i, i, i, i, i, p]
    lib.vt_repeat_forward.restype = i
    lib.vt_repeat_smem_bytes.argtypes = [i] * 7
    lib.vt_repeat_smem_bytes.restype = ctypes.c_longlong
    lib.vt_repeat_tile_rows.argtypes = [i] * 7
    lib.vt_repeat_tile_rows.restype = i
    lib.vt_repeat_col_groups.argtypes = [i] * 8
    lib.vt_repeat_col_groups.restype = i
    return lib


def launch_plan(x_bf16: bool, bsz: int, t: int, cx: int, c_out: int,
                c_in: int, has_res: bool, kernel: int) -> tuple:
    """(time rows per block, blocks per tile) of one kernel launch on the
    current CUDA device: the kernel picks 64 rows, or 32 for a grid that
    fits in one wave, and splits the output columns of a small 32-row grid
    over two blocks (see csrc/repeat_block.cu)."""
    lib = _lib()
    return (lib.vt_repeat_tile_rows(int(x_bf16), bsz, t, cx, c_in,
                                    int(has_res), kernel),
            lib.vt_repeat_col_groups(int(x_bf16), bsz, t, cx, c_out, c_in,
                                     int(has_res), kernel))


def _need(name: str, tsr: torch.Tensor, device: torch.device, dtype,
          shape) -> None:
    if tsr.device != device:
        raise ValueError(f"repeat kernel: {name} must be on {device}, "
                         f"got {tsr.device}")
    if tsr.dtype != dtype or not tsr.is_contiguous():
        raise ValueError(f"repeat kernel: {name} must be contiguous {dtype}, "
                         f"got {tsr.dtype}")
    if tuple(tsr.shape) != tuple(shape):
        raise ValueError(f"repeat kernel: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(tsr.shape)}")
    if tsr.data_ptr() % 32:
        raise ValueError(f"repeat kernel: {name} must be 32-byte aligned")


def fused_repeat_block_cuda(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *,
                            kernel: int, last_act: bool = False
                            ) -> torch.Tensor:
    """The kernel: one launch per repeat, CUDA tensors only.

    Operands are brought to the kernel's types first (a no-op when they
    already are, as the model keeps them): x bf16 or fp32, lens int32, dw
    and biases fp32, pw and res_w bf16. Every channel count must be a
    multiple of 16 (the bf16 MMA tile)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"repeat kernel: x must be a CUDA tensor, got {dev}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 3:
        raise ValueError("repeat kernel: x must be (B, T, C) bf16 or fp32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    bsz, t, c_in = x.shape
    r = len(dw_ws)
    if r < 1 or len(pw_ws) != r or len(bs) != r:
        raise ValueError("repeat kernel: dw_ws, pw_ws and bs need R >= 1 "
                         "entries each")
    c_out = pw_ws[-1].shape[1]
    has_res = res_w is not None
    if kernel % 2 != 1:
        raise ValueError("repeat kernel: kernel must be odd ('same' padding)")
    if (c_in % 16) or (c_out % 16):
        raise ValueError("repeat kernel: channel counts must be multiples "
                         f"of 16, got C_in={c_in} C_out={c_out}")
    x = x.contiguous()
    lens = lens.to(torch.int32).contiguous()
    _need("x", x, dev, x.dtype, (bsz, t, c_in))
    _need("lens", lens, dev, torch.int32, (bsz,))
    xres = None
    if has_res:
        xres = x.to(torch.bfloat16)
        res_w = res_w.to(torch.bfloat16).contiguous()
        res_b = res_b.to(torch.float32).contiguous()
        _need("res_w", res_w, dev, torch.bfloat16, (c_in, c_out))
        _need("res_b", res_b, dev, torch.float32, (c_out,))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cur = x
    for i in range(r):
        cx = c_in if i == 0 else c_out
        last = i == r - 1
        dw = dw_ws[i].to(torch.float32).contiguous()
        pw = pw_ws[i].to(torch.bfloat16).contiguous()
        b = bs[i].to(torch.float32).contiguous()
        _need(f"dw_ws[{i}]", dw, dev, torch.float32, (kernel, cx))
        _need(f"pw_ws[{i}]", pw, dev, torch.bfloat16, (cx, c_out))
        _need(f"bs[{i}]", b, dev, torch.float32, (c_out,))
        res = last and has_res
        # intermediates between repeats stay fp32 (the TPU kernel kept
        # them fp32 in VMEM); the block output takes x's dtype
        out = torch.empty((bsz, t, c_out),
                          dtype=x.dtype if last else torch.float32,
                          device=dev)
        with torch.cuda.device(dev):
            smem = lib.vt_repeat_smem_bytes(int(cur.dtype == torch.bfloat16),
                                            bsz, t, cx, c_in, int(res),
                                            kernel)
            if smem > _build.SMEM_LIMIT:
                raise ValueError(f"repeat kernel: {smem} B of shared memory "
                                 f"for C={cx}, K={kernel} exceeds "
                                 f"{_build.SMEM_LIMIT}")
            err = lib.vt_repeat_forward(
                cur.data_ptr(), int(cur.dtype == torch.bfloat16),
                xres.data_ptr() if res else None, lens.data_ptr(),
                dw.data_ptr(), pw.data_ptr(), b.data_ptr(),
                res_w.data_ptr() if res else None,
                res_b.data_ptr() if res else None,
                out.data_ptr(), int(out.dtype == torch.bfloat16), bsz, t,
                cx, c_out, c_in, kernel, int(not last or last_act), stream)
        _build.check(lib, err, "repeat kernel")
        fused_repeat_block.launches += 1
        cur = out
    return cur


def fused_repeat_block(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *,
                       kernel: int, last_act: bool = False) -> torch.Tensor:
    """(B, T, C_in) -> (B, T, C_out): the block's output after residual +
    ReLU. CUDA tensors go through the kernel (launches counted in
    `.launches`); CPU tensors through its plain version.

    `last_act=True` also applies ReLU after the final repeat BEFORE the
    residual add (not used by QuartzNet; kept for generality)."""
    if custom_ops.active():
        return torch.ops.vietasr.repeat_block(
            x, lens, list(dw_ws), list(pw_ws), list(bs), res_w, res_b,
            kernel, last_act)
    return _route(x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel, last_act)


fused_repeat_block.launches = 0


def _route(x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel, last_act):
    fn = fused_repeat_block_plain if x.device.type == "cpu" \
        else fused_repeat_block_cuda
    return fn(x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel=kernel,
              last_act=last_act)


_repeat_op = torch.library.custom_op(
    "vietasr::repeat_block", _route, mutates_args=(),
    schema="(Tensor x, Tensor lens, Tensor[] dw_ws, Tensor[] pw_ws, "
           "Tensor[] bs, Tensor? res_w, Tensor? res_b, int kernel, "
           "bool last_act) -> Tensor")


@_repeat_op.register_fake
def _(x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel, last_act):
    return x.new_empty((x.shape[0], x.shape[1], pw_ws[-1].shape[1]))


def block_eligible(bcfg, params, training: bool) -> bool:
    """Can this block take the fused path? Separable, stride 1, dilation 1,
    no groups/heads/SE, folded BN, at most one plain residual pane."""
    return (not training
            and bcfg.separable
            and bcfg.stride == 1
            and bcfg.dilation == 1
            and bcfg.groups <= 1
            and bcfg.heads <= 0
            and not bcfg.se
            and all("b" in s for s in params["sub"])       # folded BN
            and len(params["res"]) <= 1
            and all("b" in p and "se" not in p for p in params["res"]))
