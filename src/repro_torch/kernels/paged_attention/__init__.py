"""K2a (float pool) and K2b (quantized pool) paged single-token decode
attention: CUDA kernels and their plain version."""
