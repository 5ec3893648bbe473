"""Entry point of whole-prompt attention, mirroring
``repro/kernels/flash_attention/ops.py:flash_attention_op``: GQA is taken by
the kernel's head indexing (K7), not by repeating K/V as ``repro`` does."""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: int | None = None,
                       softcap: float | None = None,
                       sinks: int = 0) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) with Hq % Hkv == 0 ->
    (B, Hq, S, D) in q's dtype. A CUDA tensor goes to K7, a CPU tensor to
    the plain version (``flash_attention_ref``)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, sinks=sinks)
