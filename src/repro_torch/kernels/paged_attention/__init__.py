"""K2a: paged single-token decode attention (CUDA kernel + plain version)."""
