"""Rounding of operands to a lower precision than float32, for controls:
the reference put in the program's place and computed one step below the
precision the configuration states."""

from __future__ import annotations

import torch

FP8_MAX = 448.0           # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude at FP8_MAX), as fp8 training scales a tensor; the gradient
    passes straight through."""
    amax = x.detach().abs().max().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back: a convolution's operands as the
    configurations state their compute (bf16 operands, fp32 sums)."""
    return x.to(torch.bfloat16).to(x.dtype)
