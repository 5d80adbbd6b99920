"""vietasr_tpu_torch — the PyTorch/CUDA port of vietasr_tpu for NVIDIA Hopper.

The JAX package `vietasr_tpu` stays the reference; this package mirrors its
module layout (frontend/, models/, ops/, utils/, pipeline.py) so each
counterpart is found at the same path, and holds its own copies of every
helper it needs: it imports torch, never jax, flax or vietasr_tpu.

Every Pallas kernel on a ported path has a hand-written CUDA kernel for
sm_90a under `csrc/`, built with nvcc at first use (`_build.py`) and bound
with ctypes. Each kernel's wrapper launches it for CUDA tensors and takes
its plain PyTorch version only for CPU tensors.

Entry points run on the GPU (`device=None` means "cuda") and raise when
there is none; tests pass `device="cpu"`.
"""

from vietasr_tpu_torch.version import __version__

__all__ = ["__version__"]
