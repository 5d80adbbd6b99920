"""Device choice for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the GPU. Raises when CUDA is asked for and absent: the
    port never carries on silently on the CPU; callers that want the CPU
    (the tests) say `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vietasr_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def strict_fp32():
    """Run the enclosed cuDNN convolutions and cuBLAS matmuls in IEEE fp32
    whatever the global flags say: cuDNN defaults to TF32 on Ampere and
    later (`torch.backends.cudnn.allow_tf32` is True), which rounds the
    operands to 10 mantissa bits. The flags are restored on exit."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = old


@contextlib.contextmanager
def exact_tensor_cores():
    """Let the enclosed cuBLAS matmuls and cuDNN convolutions use TF32
    tensor cores. Exact for operands that hold bf16 (or fp16) values: TF32
    keeps 10 mantissa bits, so rounding such a value to TF32 changes
    nothing, and the products accumulate in fp32, which is a bf16 product
    with an fp32 result. The flags are restored on exit."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=True):
            yield
    finally:
        matmul.allow_tf32 = old
