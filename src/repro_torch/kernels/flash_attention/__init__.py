"""K7 whole-prompt flash attention (causal, optional sliding window with
sinks, optional softcap): the CUDA kernel and its plain version."""
