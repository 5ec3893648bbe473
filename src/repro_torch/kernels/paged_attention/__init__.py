"""K2a (float pool), K2b (quantized pool) and K2c (either, under a sliding
window with sinks) paged single-token decode attention: CUDA kernels and
their plain version."""
