"""NWC conv / norm primitives for the QuartzNet encoder (counterpart of
vietasr_tpu/models/layers.py: convolutions, batch norm in both modes,
dropout and the torch-compatible initializers).

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

import math

import torch
import torch.nn.functional as F

from vietasr_tpu_torch.parallel.collectives import all_reduce_sum

BN_EPS = 1e-3
BN_MOMENTUM = 0.1


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
    """Full conv: x (B, T, Cin), w (K, Cin // groups, Cout) -> (B, T', Cout).
    A plain 1x1 is `pointwise_conv` (fp32 result); any other conv
    accumulates in fp32 and returns x's dtype, as JAX's conv does."""
    if w.shape[0] == 1 and stride == 1 and padding == 0 and groups == 1:
        return pointwise_conv(x, w[0])
    y = F.conv1d(x.to(torch.float32).transpose(1, 2),
                 w.to(torch.float32).permute(2, 1, 0), stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2).to(x.dtype)


def init_batchnorm(c: int, *, device=None):
    """(params {scale 1, bias 0}, stats {mean 0, var 1}) for C channels."""
    params = {"scale": torch.ones(c, device=device),
              "bias": torch.zeros(c, device=device)}
    stats = {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)}
    return params, stats


def batchnorm_apply(x: torch.Tensor, params: dict, stats: dict, *,
                    training: bool = False, eps: float = BN_EPS,
                    momentum: float = BN_MOMENTUM, group=None):
    """BatchNorm over the last axis of x (B, T, C). Returns (y, new_stats).

    Training (torch BatchNorm1d semantics, as the JAX package): statistics
    over (B, T) including padding, the biased variance to normalize, the
    unbiased one in the running update; the new stats carry no gradient.
    With a process `group` the statistics are those of the global batch,
    as the JAX package's sharded step takes them: the mean is the
    all-reduced sum over the all-reduced row count n, the variance the
    all-reduced sum of (x - mean)^2 over n (the same two passes), and the
    running update's unbiased factor is n / (n - 1) of the global n.
    Eval: the running stats normalize and pass through."""
    if training and group is not None:
        local = torch.cat([x.sum(dim=(0, 1)),
                           x.new_full((1,), x.shape[0] * x.shape[1])])
        total = all_reduce_sum(local, group)
        n = total[-1].detach()
        mean = total[:-1] / n
        var = all_reduce_sum(((x - mean) ** 2).sum(dim=(0, 1)), group) / n
        factor = n / torch.clamp_min(n - 1, 1)
    elif training:
        n = x.shape[0] * x.shape[1]
        mean = torch.mean(x, dim=(0, 1))
        var = torch.mean((x - mean) ** 2, dim=(0, 1))
        factor = n / max(n - 1, 1)
    else:
        mean, var = stats["mean"], stats["var"]
        new_stats = stats
    if training:
        unbiased = var.detach() * factor
        new_stats = {
            "mean": (1 - momentum) * stats["mean"] + momentum * mean.detach(),
            "var": (1 - momentum) * stats["var"] + momentum * unbiased,
        }
    inv = torch.rsqrt(var + eps)
    return (x - mean) * (inv * params["scale"]) + params["bias"], new_stats


def fold_bn_into_conv(conv_w: torch.Tensor, bn_params: dict, bn_stats: dict,
                      eps: float = BN_EPS):
    """Fold BN into the preceding conv for inference. conv_w has output
    channels on its LAST axis. Returns (w_folded, bias)."""
    inv = bn_params["scale"] / torch.sqrt(bn_stats["var"] + eps)
    return conv_w * inv, bn_params["bias"] - bn_stats["mean"] * inv


def group_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel shuffle of (B, T, C): channel g * (C / groups) + j moves to
    j * groups + g."""
    b, t, c = x.shape
    return x.reshape(b, t, groups, c // groups).transpose(2, 3).reshape(
        b, t, c)


def squeeze_excite(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Squeeze-excite over time: the mean over ALL time steps, padding
    included (as the reference and JAX pool), -> relu(. @ w1) ->
    sigmoid(. @ w2) scales each channel; fp32 gate."""
    y = torch.mean(x, dim=1).to(torch.float32)             # (B, C)
    y = torch.relu(y @ params["w1"].to(torch.float32))
    y = torch.sigmoid(y @ params["w2"].to(torch.float32))
    return x * y[:, None, :]


# jax.nn.selu's constants
SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def _selu(x: torch.Tensor) -> torch.Tensor:
    neg = SELU_ALPHA * torch.expm1(torch.clamp_max(x, 0.0))
    return SELU_SCALE * torch.where(x > 0, x, neg)


def activation_fn(name: str):
    """relu; hardtanh as clip(x, 0, 20) (the reference's range, not
    torch's default -1..1); selu with jax.nn.selu's constants."""
    if name == "relu":
        return torch.relu
    if name == "hardtanh":
        return lambda x: torch.clamp(x, 0.0, 20.0)
    if name == "selu":
        return _selu
    raise ValueError(f"unsupported activation {name!r}")


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], training: bool
            ) -> torch.Tensor:
    """Inverted dropout with its keep mask drawn from `generator` (the JAX
    package draws raw bits from a key: the masks differ, the distribution
    is the same)."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# initializers (torch-compatible), drawn from a torch.Generator


def symmetric_uniform(generator, shape, bound: float, *, device=None
                      ) -> torch.Tensor:
    """U(-bound, bound) from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    return -bound + (2.0 * bound) * u


def xavier_uniform(generator, shape, fan_in: int, fan_out: int, *,
                   device=None) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ with gain 1 (reference init_weights)."""
    return symmetric_uniform(generator, shape,
                             math.sqrt(6.0 / (fan_in + fan_out)),
                             device=device)


def kaiming_uniform(generator, shape, fan_in: int, *, device=None
                    ) -> torch.Tensor:
    """torch kaiming_uniform_ with nonlinearity='relu' (gain sqrt(2))."""
    return symmetric_uniform(generator, shape,
                             math.sqrt(2.0) * math.sqrt(3.0 / fan_in),
                             device=device)
