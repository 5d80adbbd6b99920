"""Post-training int8 quantization for QuartzNet serving (counterpart of
vietasr_tpu/models/quantize.py).

Serving quantizes the 1x1 (pointwise) products, which carry most of the
encoder's operations, and leaves everything else in bf16 / fp32:

- weights: per-out-channel symmetric int8, quantized from the fp32
  BN-folded weights (the channel scales absorb the BN gain exactly);
- activations: per-tensor symmetric int8 with static scales from one
  calibration forward over representative audio (abs-max, no zero
  points);
- the product accumulates in int32 and is dequantized by one fused
  (x_scale * w_scale[c]) multiply, then bias and activation as usual.

It plugs into `quartznet_apply(pw_fn=...)`, so the quantized model shares
every other code path (masking, residuals, head) with the float one; a
pw_fn runs every block per-op, as in JAX. Rounding is half to even, as
`jnp.round` rounds.

The int8 GEMM. On CUDA tensors it is `torch._int_mm` (cuBLASLt's int8
tensor-core GEMM, int32 out), as the JAX package leaves its int8
`dot_general` to XLA. cuBLASLt takes more than 16 rows and a width that
is a multiple of 8, so rows are zero-padded to 17 and the head's 91
columns are held padded to 96; and it takes the weight column-major (the
"TN" layout of its int8 kernels: with both operands row-major it refused
K = 64 at row counts that are not multiples of 32 on the H100), so
`QuantizedPointwise.w_i8` is held so on CUDA (`gemm_weight`). Its plain
version, for CPU tensors, is the exact integer product as an
fp32 matmul of the int8 values: every partial sum is an integer below
127 * 127 * 1040 < 2^24, so fp32 holds it exactly in any order (int8
tensors would multiply in int8 and wrap).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from vietasr_tpu_torch.config import EncoderConfig
from vietasr_tpu_torch.models.layers import pointwise_conv
from vietasr_tpu_torch.models.quartznet import quartznet_apply

# the widest input an fp32 product of int8 values holds exactly:
# 127 * 127 * K < 2^24
EXACT_K = (1 << 24) // (127 * 127)
# torch._int_mm (cuBLASLt) takes more than 16 rows, widths a multiple of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


class QuantizedPointwise(NamedTuple):
    """One quantized 1x1-conv site."""

    w_i8: torch.Tensor     # (Cin, Cout) int8; on CUDA gemm_weight's
    w_scale: torch.Tensor  # (Cout,) fp32, per out channel
    x_scale: torch.Tensor  # () fp32, per tensor


def quantize_weight(w: torch.Tensor):
    """Per-out-channel symmetric int8: w (Cin, Cout) -> (w_i8, scale)."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=0)                             # (Cout,)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    w_i8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_i8, scale


def int8_matmul_plain(x_i8: torch.Tensor, w_i8: torch.Tensor
                      ) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exactly, on any
    device: an fp32 product of the integer values (K <= EXACT_K)."""
    if x_i8.shape[-1] > EXACT_K:
        raise ValueError(f"int8 GEMM: K = {x_i8.shape[-1]} > {EXACT_K}, "
                         "past fp32's exact integers")
    return torch.matmul(x_i8.to(torch.float32),
                        w_i8.to(torch.float32)).to(torch.int32)


def int8_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32: cuBLASLt's int8 GEMM
    (`torch._int_mm`) on CUDA tensors, the exact plain product on CPU
    tensors. On CUDA, w_i8 must be as gemm_weight lays it out (N a
    multiple of 8, column-major); rows are padded to cuBLASLt's minimum
    here."""
    if x_i8.device.type == "cpu":
        return int8_matmul_plain(x_i8, w_i8)
    if x_i8.device.type != "cuda" or w_i8.device != x_i8.device:
        raise ValueError(f"int8 GEMM: operands on {x_i8.device} and "
                         f"{w_i8.device}")
    k, n = w_i8.shape
    if k % _INT_MM_ALIGN or n % _INT_MM_ALIGN or w_i8.stride() != (1, k):
        raise ValueError(f"int8 GEMM: the weight must be column-major with "
                         f"K = {k} and N = {n} multiples of {_INT_MM_ALIGN} "
                         "on CUDA (gemm_weight)")
    m = x_i8.shape[0]
    if m < _INT_MM_MIN_ROWS:
        x_i8 = torch.nn.functional.pad(x_i8, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(x_i8.contiguous(), w_i8)[:m]


def gemm_weight(w_i8: torch.Tensor) -> torch.Tensor:
    """w_i8 as int8_matmul takes it on its device: on CUDA its columns
    zero-padded to a multiple of 8 (the head's 91 to 96) and held
    column-major, a (K, N) view of an (N, K) tensor."""
    if w_i8.device.type != "cuda":
        return w_i8
    w_i8 = torch.nn.functional.pad(w_i8, (0, -w_i8.shape[1] % _INT_MM_ALIGN))
    return w_i8.t().contiguous().t()


def calibrate_activations(variables: dict, cfg: EncoderConfig,
                          feats: torch.Tensor, feat_lens: torch.Tensor, *,
                          compute_dtype=torch.bfloat16) -> Dict[str, float]:
    """One forward recording the abs-max of every pointwise-conv INPUT
    (in the dtype the site receives it). `feats` should be real
    featurized audio: the scales are static thereafter."""
    amax: Dict[str, torch.Tensor] = {}

    def pw_cal(tag, x, w):
        amax[tag] = x.to(torch.float32).abs().amax()
        return pointwise_conv(x, w)

    with torch.inference_mode():
        quartznet_apply(variables, feats, feat_lens, cfg=cfg,
                        compute_dtype=compute_dtype, pw_fn=pw_cal)
    return {tag: float(v) for tag, v in amax.items()}


def quantize_quartznet(variables: dict, cfg: EncoderConfig,
                       act_amax: Dict[str, float]
                       ) -> Dict[str, QuantizedPointwise]:
    """The int8 tables for every calibrated pointwise site.

    `variables` must be BN-FOLDED and fp32 (fold_batchnorm, before
    cast_matmul_weights): the per-channel scales then absorb the BN gain
    and equal JAX's. Sites missing from `act_amax` stay float. On CUDA the
    weights' columns are zero-padded to a multiple of 8 (the int8 GEMM's
    width)."""
    tables: Dict[str, QuantizedPointwise] = {}
    params = variables["params"]

    def add(tag, w):
        if tag not in act_amax:
            return
        w_i8, w_scale = quantize_weight(w)
        # JAX: jnp.float32(max(amax, 1e-12) / 127.0), a Python division
        x_scale = torch.tensor(max(act_amax[tag], 1e-12) / 127.0,
                               dtype=torch.float32, device=w.device)
        tables[tag] = QuantizedPointwise(gemm_weight(w_i8), w_scale,
                                         x_scale)

    for i, bcfg in enumerate(cfg.blocks):
        bp = params["encoder"][i]
        if bcfg.separable and bcfg.groups == 1:
            for r, sub in enumerate(bp["sub"]):
                add(f"enc{i}.sub{r}", sub["pw_w"])
        for p, pane in enumerate(bp["res"]):
            add(f"enc{i}.res{p}", pane["conv_w"])
    add("dec", params["decoder"]["w"])
    return tables


def int8_pw_fn(tables: Dict[str, QuantizedPointwise],
               matmul: Callable = int8_matmul):
    """pw_fn for quartznet_apply: the int8 GEMM at quantized sites, the
    float product elsewhere. The output takes the input's dtype (bf16 in
    bf16 mode), as JAX's `deq.astype(x.dtype)`. `matmul` is the int8
    GEMM (int8_matmul; int8_matmul_plain to hold it against)."""

    def pw(tag, x, w):
        q = tables.get(tag)
        if q is None:
            return pointwise_conv(x, w)
        x_i8 = torch.clamp(torch.round(x.to(torch.float32) / q.x_scale),
                           -127, 127).to(torch.int8)
        acc = matmul(x_i8.reshape(-1, x_i8.shape[-1]), q.w_i8)
        cout = q.w_scale.shape[0]
        acc = acc[:, :cout].reshape(*x.shape[:-1], cout)
        deq = acc.to(torch.float32) * (q.x_scale * q.w_scale)
        return deq.to(x.dtype)

    return pw


def quantized_apply_fn(variables: dict, cfg: EncoderConfig,
                       tables: Dict[str, QuantizedPointwise]):
    """(feats, feat_lens) -> (log_probs, out_lens): the int8 serving
    forward in bf16."""
    pw = int8_pw_fn(tables)

    def apply(feats, feat_lens):
        return quartznet_apply(variables, feats, feat_lens, cfg=cfg,
                               compute_dtype=torch.bfloat16, pw_fn=pw)

    return apply
