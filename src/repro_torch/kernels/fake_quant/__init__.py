"""K3 fused gated fake-quant: the CUDA kernel and its plain version."""
