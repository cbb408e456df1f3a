"""One NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no sparsity),
at its full 700 W power limit."""

BF16_FLOPS = 989e12  # bf16 FLOP/s on the tensor cores
FP32_FLOPS = 67e12  # float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
HBM_BYTES = 80e9
