"""PyTorch + CUDA port of ``repro`` (CGMQ), for NVIDIA Hopper.

The package mirrors ``repro``'s module tree and function names so every
function has an obvious twin: ``repro_torch/models/attention.py:
attention_decode_paged`` is the counterpart of ``repro/models/attention.py:
attention_decode_paged``. Parameters stay in ``repro``'s layout (nested
dicts of tensors, scan-stacked layers keep their leading ``R`` axis), so the
test bridge (``repro_torch.bridge``) is a plain numpy conversion.

What is ported so far is the paged greedy serving path of the dense
decoder (``serving.engine.ServingEngine``): 2/4/8-bit per-channel weight
codes (2- and 4-bit ones packed along K) through the hand-written
``quant_matmul`` / ``quant_matmul_packed`` CUDA kernels, a paged KV cache
of bf16/fp32 values or int8/int4 codes with fp16 group scales through the
hand-written ``paged_attention`` / ``paged_attention_quant`` CUDA kernels,
greedy decode and wave admission. Options of ``repro``'s API that are not
ported yet raise ``NotImplementedError`` naming the ROADMAP item that ports
them.

The package imports ``torch`` and ``numpy`` only: never ``jax`` and never
``repro``. Every entry point takes ``device=None``, meaning ``"cuda"``; it
raises when no card is present unless the caller passes ``device="cpu"``.
"""
