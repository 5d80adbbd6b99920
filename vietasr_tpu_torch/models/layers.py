"""NWC conv / norm primitives for the QuartzNet encoder (counterpart of
vietasr_tpu/models/layers.py, inference subset).

Activations are (B, T, C), channels last, as in the JAX package; the
convolutions transpose to PyTorch's (B, C, T) around `F.conv1d` and back.
Weight layouts are the JAX ones: depthwise `(K, C)`, pointwise
`(Cin, Cout)`, dense `(K, Cin // groups, Cout)`.

Precision: a product in the compute dtype (bf16) accumulates in fp32 and
returns fp32, as `preferred_element_type=float32` does in JAX. fp32 runs
on the GPU need TF32 off for matmuls (PyTorch's default) and for cuDNN
convolutions (`torch.backends.cudnn.allow_tf32 = False`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


def length_mask(t: int, lens: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """(B, T, 1) mask of valid positions."""
    return (torch.arange(t, device=lens.device)[None, :, None]
            < lens[:, None, None]).to(dtype)


def mask_padding(x: torch.Tensor, lens: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if lens is None:
        return x
    return x * length_mask(x.shape[1], lens, x.dtype)


def conv_out_length(lens, kernel: int, stride: int, dilation: int,
                    padding: int):
    """floor((len + 2p - d(k-1) - 1) / s) + 1."""
    return torch.div(lens + 2 * padding - dilation * (kernel - 1) - 1,
                     stride, rounding_mode="floor") + 1


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """Depthwise conv: x (B, T, C), w (K, C) -> (B, T', C), in x's dtype."""
    c = w.shape[1]
    y = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1), stride=stride,
                 padding=padding, dilation=dilation, groups=c)
    return y.transpose(1, 2)


def pointwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv: x (B, T, Cin) @ w (Cin, Cout), fp32 accumulation and
    result. bf16 operands are widened first: their products are exact in
    fp32, so this is the bf16 GEMM with fp32 accumulation."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def dense_conv1d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 dilation: int = 1, padding: int = 0,
                 groups: int = 1) -> torch.Tensor:
    """Full conv: x (B, T, Cin), w (K, Cin // groups, Cout) -> (B, T', Cout)
    in fp32."""
    if w.shape[0] == 1 and stride == 1 and padding == 0 and groups == 1:
        return pointwise_conv(x, w[0])
    y = F.conv1d(x.to(torch.float32).transpose(1, 2),
                 w.to(torch.float32).permute(2, 1, 0), stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def batchnorm_apply(x: torch.Tensor, params: dict, stats: dict, *,
                    eps: float = BN_EPS) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis of x (B, T, C)."""
    inv = torch.rsqrt(stats["var"] + eps)
    return (x - stats["mean"]) * (inv * params["scale"]) + params["bias"]


def fold_bn_into_conv(conv_w: torch.Tensor, bn_params: dict, bn_stats: dict,
                      eps: float = BN_EPS):
    """Fold BN into the preceding conv for inference. conv_w has output
    channels on its LAST axis. Returns (w_folded, bias)."""
    inv = bn_params["scale"] / torch.sqrt(bn_stats["var"] + eps)
    return conv_w * inv, bn_params["bias"] - bn_stats["mean"] * inv
