"""PyTorch + CUDA port of ``repro`` (CGMQ), for NVIDIA Hopper.

The package mirrors ``repro``'s module tree and function names so every
function has an obvious twin: ``repro_torch/models/attention.py:
attention_decode_paged`` is the counterpart of ``repro/models/attention.py:
attention_decode_paged``. Parameters stay in ``repro``'s layout (nested
dicts of tensors, scan-stacked layers keep their leading ``R`` axis), so the
test bridge (``repro_torch.bridge``) is a plain numpy conversion.

What is ported so far is the int8 paged greedy serving path of the dense
decoder (``serving.engine.ServingEngine``): int8 per-channel weight codes
through the hand-written ``quant_matmul`` CUDA kernel, a paged bf16/fp32 KV
cache through the hand-written ``paged_attention`` CUDA kernel, greedy
decode and wave admission. Options of ``repro``'s API that are not ported
yet raise ``NotImplementedError`` naming the ROADMAP item that ports them.

The package imports ``torch`` and ``numpy`` only: never ``jax`` and never
``repro``. Every entry point takes ``device=None``, meaning ``"cuda"``; it
raises when no card is present unless the caller passes ``device="cpu"``.
"""
