"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A roofline share
is stated against these, with the card's power limit printed beside it."""

BF16_FLOPS = 989e12       # bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12        # fp32 on the CUDA cores
HBM_BYTES = 3.35e12       # HBM3 bytes a second
