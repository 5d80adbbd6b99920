"""Fused QuartzNet repeat block: R x (depthwise + pointwise + folded BN +
ReLU) + residual, as ONE CUDA kernel launch per block, with a plain PyTorch
version beside it.

Counterpart of vietasr_tpu/ops/pallas_repeat.py::fused_repeat_block, with
the same contract and the numerics of its Pallas `_kernel`: the depthwise
runs in fp32 over fp32 weights with rows outside [0, len) masked before
and after it; its result is cast to bf16 for the 1x1 product with fp32
accumulation; biases are fp32; ReLU between repeats; the residual is the
masked block input through its own bf16 1x1 product plus bias; the sum
goes through a final ReLU and is stored in x's dtype. Rows beyond len come
out as relu(b_pw + b_res), as in JAX; later blocks mask them.

Two kernels serve it on the GPU. A block of R = 1 (QuartzNet12x1's) is one
launch of csrc/repeat_block.cu (`launch_plan`); a block of R >= 2
(QuartzNet15x5's R = 5) is one launch of csrc/repeat_whole_block.cu, which
keeps the fp32 intermediates between repeats in shared memory across a
thread-block cluster (`whole_block_plan`), as the Pallas kernel keeps them
in VMEM. The wrapper raises ValueError for a shape the whole-block plan
cannot take; the model's `kernel_route` asks the plan first
(`whole_block_takes`), so it sends such a block down its per-op path and
never to this wrapper.
`repeat_chain_cuda`, R launches of the one-repeat kernel with fp32
intermediates in device memory, is a yardstick that chip_smoke.py times;
no route takes it.

`fused_repeat_block` launches a kernel for CUDA tensors and takes the
plain version only for CPU tensors; `fused_repeat_block_plain` is the
plain version on any device (the reference both kernels are held to). The
same route is the custom op `vietasr::repeat_block` (ops/custom_ops.py),
which the wrapper calls while an export traces.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Callable, NamedTuple, Optional, Sequence

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


# the whole-block kernel's constants (csrc/repeat_whole_block.cu)
WHOLE_MAX_R = 16            # repeats a launch takes
WHOLE_MAX_CLUSTER = 8       # blocks a cluster (the portable size)
_WHOLE_MR, _WHOLE_KC = 128, 64          # rows a chunk / depth a weight tile
_WHOLE_WSTAGES, _WHOLE_YSTAGES = 4, 2   # weight tiles / chunks in the rings
_WHOLE_EPI_RING = 16        # epilogue mbarriers
_WHOLE_MAX_CHUNKS = _WHOLE_EPI_RING - 2   # chunks of a repeat, at most
_WHOLE_RPT = 16             # depthwise rows a thread takes at a time
_WHOLE_BAR_BYTES = 256
_WHOLE_CW_MAX = 64          # output columns a block owns, at most
_H100_SMS = 132             # SMs of an H100 SXM


class WholeBlockPlan(NamedTuple):
    """One launch of the whole-block kernel: `tile_rows` output rows a
    cluster of `cluster` blocks, each owning `cols` output columns and
    `in_cols` of the first repeat's input channels; `smem_bytes` of shared
    memory a block (for x of `x_bytes` a value); `tiles` tiles a batch
    row."""
    tile_rows: int
    cluster: int
    cols: int
    in_cols: int
    smem_bytes: int
    tiles: int
    x_bytes: int = 2


def whole_block_smem(tile_rows: int, kernel: int, repeats: int, cols: int,
                     in_cols: int, x_bytes: int = 2) -> int:
    """Shared-memory bytes of one block of the whole-block kernel, as
    csrc/repeat_whole_block.cu::layout counts them: the mbarriers; the
    4-deep weight ring (64 x cols bf16 a stage); the 2-deep ring of
    depthwise chunks (128 rows x the block's channels in 16-channel pairs,
    bf16); one repeat's taps (K x the block's channels, fp32, to 128 B);
    the repeats' fp32 outputs over E1 = E0 - 2 * K/2 rows (pitch cols) with
    x's E0 halo'd rows (in x's type) placed at E1 x (the two pitches'
    difference) into them, so that the first repeat's output rows never
    reach an x row still to be read."""
    k2 = kernel // 2
    e0 = tile_rows + 2 * repeats * k2
    e1 = e0 - 2 * k2
    cwm = max(cols, in_cols)
    p, q = cols * 4, in_cols * x_bytes
    acts = max(e1 * p, max(0, e1 * (p - q)) + e0 * q)
    return (_WHOLE_BAR_BYTES + _WHOLE_WSTAGES * _WHOLE_KC * cols * 2
            + _WHOLE_YSTAGES * (_WHOLE_MR // 16) * -(-cwm // 16) * 512
            + -(-kernel * cwm * 4 // 128) * 128 + acts)


def _clusters_at_once_model(cluster: int, smem_bytes: int) -> int:
    """Clusters an H100 holds at once, without asking the card: one block
    an SM (a block's 512 threads take the registers), whole clusters of
    them."""
    return max(1, _H100_SMS // cluster)


def whole_block_plan(bsz: int, t: int, c_in: int, c_out: int, kernel: int,
                     repeats: int, x_bytes: int = 2,
                     clusters_at_once: Optional[Callable[[int, int], int]]
                     = None) -> WholeBlockPlan:
    """The whole-block kernel's launch plan. The cluster is the fewest
    blocks (at most 8) whose column slices fit the kernel: each block owns
    C_out / N <= 64 output columns (a multiple of 16) and C_in / N
    first-repeat channels (a multiple of 8). x has `x_bytes` a value (2:
    bf16, 4: fp32; the block stages its rows in that type). The tile rows
    are the multiple of 16 that fits `_build.SMEM_LIMIT` (and at most 14
    128-row chunks a repeat) and minimises waves x a tile's time. The
    depthwise and the 1x1s run side by side in their own warps, so a
    tile's time is the larger of the two: its depthwise, R * TT + R(R-1) *
    K/2 rows (the halo is recomputed each repeat) x K taps x the block's
    channels at 128 fp32 FMA a cycle, and its 1x1s, those rows in whole
    64-row warpgroup tiles x C_x x the block's columns at 1,024 bf16 FMA a
    cycle. A wave is `clusters_at_once(N, smem bytes)` clusters: the card's
    own count where the wrapper asks it, else a model of an H100 (so the
    plan needs no card). tools/whole_block_cuts.py --tile-rows times other
    choices. Raises ValueError naming the shape when no plan fits."""
    at_once = clusters_at_once or _clusters_at_once_model
    shape = (f"(B={bsz}, T={t}, C_in={c_in}, C_out={c_out}, K={kernel}, "
             f"R={repeats})")
    # K/2 <= MR: a chunk's in-place epilogue may run beside the depthwise
    # of the chunk two later, whose windows start MR - K/2 rows past its end
    if not 1 <= repeats <= WHOLE_MAX_R or kernel % 2 != 1 \
            or kernel // 2 > _WHOLE_MR or c_in % 16 or c_out % 16 \
            or bsz < 1 or t < 1:
        raise ValueError(f"whole-block repeat kernel: no plan for {shape}: "
                         f"needs 1 <= R <= {WHOLE_MAX_R}, an odd kernel of "
                         f"at most {2 * _WHOLE_MR + 1} taps and channel "
                         "counts that are multiples of 16")
    k2 = kernel // 2
    for n in range(1, WHOLE_MAX_CLUSTER + 1):
        if c_out % n or c_in % n:
            continue
        cols, in_cols = c_out // n, c_in // n
        if cols % 16 or cols > _WHOLE_CW_MAX or in_cols % 8 \
                or in_cols > _WHOLE_CW_MAX:
            continue

        def smem(tt):
            return whole_block_smem(tt, kernel, repeats, cols, in_cols,
                                    x_bytes)

        fits = [tt for tt in range(16, -(-t // 16) * 16 + 1, 16)
                if smem(tt) <= _build.SMEM_LIMIT
                and -(-(tt + 2 * (repeats - 1) * k2) // _WHOLE_MR)
                <= _WHOLE_MAX_CHUNKS]
        if not fits:
            continue

        def cost(tt):
            # waves counted as a fraction (at least one): rows past their
            # lengths skip whole tiles, so the last wave is seldom full
            per_wave = max(1, at_once(n, smem(tt)))
            waves = max(1.0, bsz * -(-t // tt) / per_wave)
            rows = [tt + 2 * (repeats - 1 - i) * k2 for i in range(repeats)]
            chans = [in_cols] + [cols] * (repeats - 1)
            depth = [c_in] + [c_out] * (repeats - 1)
            dw = sum(e * kernel * c for e, c in zip(rows, chans)) / 128
            mm = sum(-(-e // 64) * 64 * cx * cols
                     for e, cx in zip(rows, depth)) / 1024
            return waves * max(dw, mm), -tt

        tt = min(fits, key=cost)
        return WholeBlockPlan(tt, n, cols, in_cols, smem(tt), -(-t // tt),
                              x_bytes)
    raise ValueError(f"whole-block repeat kernel: no plan for {shape}: no "
                     f"cluster of <= {WHOLE_MAX_CLUSTER} blocks gives each "
                     f"<= {_WHOLE_CW_MAX} columns (a multiple of 16) and "
                     "input channels (a multiple of 8) whose halo'd 16-row "
                     f"tile fits {_build.SMEM_LIMIT} B of shared memory "
                     f"in <= {_WHOLE_MAX_CHUNKS} chunks a repeat")


@functools.lru_cache(maxsize=None)
def whole_block_takes(c_in: int, c_out: int, kernel: int,
                      repeats: int) -> bool:
    """Does `whole_block_plan` take a bf16 block of these widths at any
    batch and length? (Its 16-row tile is the smallest, so a plan at T = 1
    stands for every T.) models/quartznet.py::kernel_route asks it before
    any launch."""
    try:
        whole_block_plan(1, 1, c_in, c_out, kernel, repeats)
    except ValueError:
        return False
    return True


@functools.lru_cache(maxsize=1)
def _whole_lib() -> ctypes.CDLL:
    lib = _build.load("repeat_whole_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vt_whole_forward.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i,
                                     i, i, i, i, i, p]
    lib.vt_whole_forward.restype = i
    lib.vt_whole_smem_bytes.argtypes = [i] * 6
    lib.vt_whole_smem_bytes.restype = ctypes.c_longlong
    lib.vt_whole_clusters_at_once.argtypes = [i] * 3
    lib.vt_whole_clusters_at_once.restype = i
    return lib


def pack_whole_weights(w: torch.Tensor, cluster: int) -> torch.Tensor:
    """A (C_x, C_out) 1x1 or residual weight for a cluster of `cluster`
    blocks, as the whole-block kernel's weight ring holds it: bf16, per
    (rank, 64-deep chunk) one tile of 64 input channels x C_out / cluster
    columns (zero rows past C_x), each tile the wgmma B operand K-major
    without swizzle, core matrices of 8 columns x 8 input channels (16
    bytes a column) with the column groups of one 8-channel slice side by
    side: (cluster, ceil(C_x / 64), 64 * C_out / cluster)."""
    cx, c_out = w.shape
    cw, nk = c_out // cluster, -(-cx // _WHOLE_KC)
    wp = w.new_zeros((nk * _WHOLE_KC, c_out), dtype=torch.bfloat16)
    wp[:cx] = w
    return (wp.view(nk, _WHOLE_KC // 8, 8, cluster, cw // 8, 8)
            .permute(3, 0, 1, 4, 5, 2).contiguous()
            .view(cluster, nk, _WHOLE_KC * cw))


def pack_whole_taps(dw: torch.Tensor, cluster: int) -> torch.Tensor:
    """(K, C_x) fp32 depthwise taps -> (cluster, K, C_x / cluster): each
    block's channels contiguous, one bulk copy a repeat."""
    k, cx = dw.shape
    return dw.to(torch.float32).view(k, cluster, cx // cluster) \
        .permute(1, 0, 2).contiguous()


# id(tensor) -> (weak reference, (data pointer, version), {(cluster, what):
# packed}); an entry goes with its tensor
_WHOLE_PACKED: dict = {}


def _packed(t: torch.Tensor, cluster: int, what: str) -> torch.Tensor:
    """`t` packed for the kernel (what: "w" pack_whole_weights, "dw"
    pack_whole_taps), once per weight tensor: cached while the tensor
    lives, its data pointer and version unchanged. A tensor made in
    inference mode has no version (PyTorch refuses to change it in place
    outside inference mode); its packs are kept while it lives, so replace
    such a weight rather than change it in place. Packs are counted in
    repeat_whole_block_cuda.packs."""
    stamp = (t.data_ptr(), None if t.is_inference() else t._version)
    key = id(t)
    entry = _WHOLE_PACKED.get(key)
    if entry is None or entry[0]() is not t or entry[1] != stamp:
        entry = (weakref.ref(t, lambda ref, key=key: _forget(key, ref)),
                 stamp, {})
        _WHOLE_PACKED[key] = entry
    packed = entry[2].get((cluster, what))
    if packed is None:
        fn = pack_whole_weights if what == "w" else pack_whole_taps
        packed = entry[2][(cluster, what)] = fn(t, cluster)
        repeat_whole_block_cuda.packs += 1
    return packed


def _forget(key: int, ref) -> None:
    if _WHOLE_PACKED.get(key, (None,))[0] is ref:
        del _WHOLE_PACKED[key]


def whole_block_kernel_smem(plan: WholeBlockPlan, kernel: int,
                            repeats: int) -> int:
    """The shared-memory bytes the built kernel counts for `plan` (equal
    to plan.smem_bytes; chip_smoke.py checks)."""
    return _whole_lib().vt_whole_smem_bytes(plan.tile_rows, kernel, repeats,
                                            plan.cols, plan.in_cols,
                                            plan.x_bytes)


@functools.lru_cache(maxsize=None)
def _clusters_at_once(device: int, x_bf16: bool, cluster: int,
                      smem_bytes: int) -> int:
    lib = _whole_lib()
    with torch.cuda.device(device):
        n = lib.vt_whole_clusters_at_once(int(x_bf16), cluster, smem_bytes)
    _build.check(lib, max(-n, 0), "whole-block repeat kernel occupancy")
    return n


def whole_block_clusters_at_once(cluster: int, smem_bytes: int,
                                 x_bf16: bool = True,
                                 device: Optional[int] = None) -> int:
    """Clusters of `cluster` blocks with `smem_bytes` each that the CUDA
    device (default: the current one) holds at once."""
    dev = torch.cuda.current_device() if device is None else device
    return _clusters_at_once(dev, bool(x_bf16), cluster, smem_bytes)


@functools.lru_cache(maxsize=1024)
def _device_plan(device: int, bsz: int, t: int, c_in: int, c_out: int,
                 kernel: int, repeats: int, x_bytes: int) -> WholeBlockPlan:
    """whole_block_plan with the CUDA device's own cluster occupancy, once
    per device and shape (a plan costs ~0.25 ms of host time, more than
    the launch it plans)."""
    at_once = functools.partial(whole_block_clusters_at_once,
                                x_bf16=x_bytes == 2, device=device)
    return whole_block_plan(bsz, t, c_in, c_out, kernel, repeats,
                            x_bytes=x_bytes, clusters_at_once=at_once)


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


def _operands(x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel):
    """The operands in the kernels' types (a no-op when they already are,
    as the model keeps them), checked: x bf16 or fp32, lens int32, dw and
    biases fp32, pw and res_w bf16, every channel count a multiple of 16
    (the bf16 MMA tile)."""
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
    if kernel % 2 != 1:
        raise ValueError("repeat kernel: kernel must be odd ('same' padding)")
    if (c_in % 16) or (c_out % 16):
        raise ValueError("repeat kernel: channel counts must be multiples "
                         f"of 16, got C_in={c_in} C_out={c_out}")
    x = x.contiguous()
    lens = lens.to(torch.int32).contiguous()
    _need("x", x, dev, x.dtype, (bsz, t, c_in))
    _need("lens", lens, dev, torch.int32, (bsz,))
    if res_w is not None:
        res_w = res_w.to(torch.bfloat16).contiguous()
        res_b = res_b.to(torch.float32).contiguous()
        _need("res_w", res_w, dev, torch.bfloat16, (c_in, c_out))
        _need("res_b", res_b, dev, torch.float32, (c_out,))
    dws, pws, bss = [], [], []
    for i in range(r):
        cx = c_in if i == 0 else c_out
        dws.append(dw_ws[i].to(torch.float32).contiguous())
        pws.append(pw_ws[i].to(torch.bfloat16).contiguous())
        bss.append(bs[i].to(torch.float32).contiguous())
        _need(f"dw_ws[{i}]", dws[i], dev, torch.float32, (kernel, cx))
        _need(f"pw_ws[{i}]", pws[i], dev, torch.bfloat16, (cx, c_out))
        _need(f"bs[{i}]", bss[i], dev, torch.float32, (c_out,))
    return x, lens, dws, pws, bss, res_w, res_b


def _one_repeat(cur, xres, lens, dw, pw, b, res_w, res_b, out, c_in, kernel,
                act_z) -> None:
    """One launch of the one-repeat kernel (csrc/repeat_block.cu): cur ->
    out, with the residual of xres (bf16 block input) when it is given."""
    lib = _lib()
    bsz, t, cx = cur.shape
    res = xres is not None
    with torch.cuda.device(cur.device):
        smem = lib.vt_repeat_smem_bytes(int(cur.dtype == torch.bfloat16),
                                        bsz, t, cx, c_in, int(res), kernel)
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
            cx, out.shape[2], c_in, kernel, int(act_z),
            torch.cuda.current_stream(cur.device).cuda_stream)
    _build.check(lib, err, "repeat kernel")
    fused_repeat_block.launches += 1


def repeat_chain_cuda(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *,
                      kernel: int, last_act: bool = False) -> torch.Tensor:
    """A yardstick, on no route: the block as R launches of the one-repeat
    kernel, whose fp32 intermediates go through device memory (the
    residual rides the last launch). chip_smoke.py times it beside the
    whole-block kernel."""
    x, lens, dws, pws, bss, res_w, res_b = _operands(
        x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel)
    bsz, t, c_in = x.shape
    c_out = pws[-1].shape[1]
    xres = x.to(torch.bfloat16) if res_w is not None else None
    r = len(dws)
    cur = x
    for i in range(r):
        last = i == r - 1
        out = torch.empty((bsz, t, c_out),
                          dtype=x.dtype if last else torch.float32,
                          device=x.device)
        _one_repeat(cur, xres if last else None, lens, dws[i], pws[i],
                    bss[i], res_w, res_b, out, c_in, kernel,
                    not last or last_act)
        cur = out
    return cur


def repeat_whole_block_cuda(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *,
                            kernel: int, last_act: bool = False
                            ) -> torch.Tensor:
    """The whole-block kernel (csrc/repeat_whole_block.cu): all R repeats
    and the residual in one launch, CUDA tensors only; launches counted in
    `.launches`. The taps and the 1x1 and residual weights go in packed for
    the plan's cluster, once per weight tensor (`_packed`; packs counted
    in `.packs`). Raises ValueError for a shape `whole_block_plan` cannot
    take, RuntimeError for a failed build or launch."""
    x, lens, dws, pws, bss, res_w, res_b = _operands(
        x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel)
    bsz, t, c_in = x.shape
    c_out = pws[-1].shape[1]
    r = len(dws)
    plan = _device_plan(x.device.index, bsz, t, c_in, c_out, kernel, r,
                        x.element_size())
    out = torch.empty((bsz, t, c_out), dtype=x.dtype, device=x.device)
    n = plan.cluster
    dws = [_packed(a, n, "dw") for a in dws]
    pws = [_packed(a, n, "w") for a in pws]
    ptrs = lambda ts: (ctypes.c_void_p * r)(*(a.data_ptr() for a in ts))  # noqa: E731
    has_res = res_w is not None
    resw = _packed(res_w, n, "w") if has_res else None
    lib = _whole_lib()
    with torch.cuda.device(x.device):
        err = lib.vt_whole_forward(
            x.data_ptr(), int(x.dtype == torch.bfloat16), lens.data_ptr(),
            ptrs(dws), ptrs(pws), ptrs(bss), r,
            resw.data_ptr() if has_res else None,
            res_b.data_ptr() if has_res else None,
            out.data_ptr(), bsz, t, c_in, c_out, kernel, int(last_act),
            plan.tile_rows, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "whole-block repeat kernel")
    repeat_whole_block_cuda.launches += 1
    return out


repeat_whole_block_cuda.launches = 0
repeat_whole_block_cuda.packs = 0


def fused_repeat_block_cuda(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *,
                            kernel: int, last_act: bool = False
                            ) -> torch.Tensor:
    """The kernels, CUDA tensors only: R = 1 is one launch of the
    one-repeat kernel (counted in `fused_repeat_block.launches`), R >= 2
    one launch of the whole-block kernel (`repeat_whole_block_cuda`)."""
    if len(dw_ws) >= 2:
        return repeat_whole_block_cuda(x, lens, dw_ws, pw_ws, bs, res_w,
                                       res_b, kernel=kernel,
                                       last_act=last_act)
    x, lens, dws, pws, bss, res_w, res_b = _operands(
        x, lens, dw_ws, pw_ws, bs, res_w, res_b, kernel)
    out = torch.empty((x.shape[0], x.shape[1], pws[0].shape[1]),
                      dtype=x.dtype, device=x.device)
    xres = x.to(torch.bfloat16) if res_w is not None else None
    _one_repeat(x, xres, lens, dws[0], pws[0], bss[0], res_w, res_b, out,
                x.shape[2], kernel, last_act)
    return out


def fused_repeat_block(x, lens, dw_ws, pw_ws, bs, res_w, res_b, *,
                       kernel: int, last_act: bool = False) -> torch.Tensor:
    """(B, T, C_in) -> (B, T, C_out): the block's output after residual +
    ReLU. CUDA tensors go through a kernel, one launch a block: R = 1
    through the one-repeat kernel (launches counted in `.launches`), R >= 2
    through the whole-block kernel (`repeat_whole_block_cuda.launches`);
    CPU tensors through its plain version.

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
