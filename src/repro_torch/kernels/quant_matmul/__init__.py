"""K1: int8 fused dequant GEMM (CUDA kernel + plain version)."""
