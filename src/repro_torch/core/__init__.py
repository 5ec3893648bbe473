"""CGMQ core: quantizer, gates and quantization sites (forward only)."""
