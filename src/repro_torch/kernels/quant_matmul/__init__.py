"""K1 (int8) and K4 (packed 2/4-bit) fused dequant GEMMs: CUDA kernels and
their plain versions."""
