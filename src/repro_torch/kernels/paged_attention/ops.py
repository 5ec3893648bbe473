"""Entry point of paged decode attention, mirroring
``repro/kernels/paged_attention/ops.py:paged_attention_op`` without a
window: a float pool goes to K2a, a quantized pool (``k_scale``/``v_scale``
given) to K2b."""

from __future__ import annotations

import torch

from .paged_attention import paged_attention, paged_attention_quant


def paged_attention_op(q, k_pool, v_pool, block_table, pos, *,
                       softcap: float | None = None, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """q: (B, KV, G, hd); pools: (num_blocks, bs, KV, hd) bf16/fp32, or
    integer codes with ``k_scale``/``v_scale`` (num_blocks, bs, KV, ng) fp16
    group scales; block_table: (B, max_blocks); pos: (B,) -> (B, KV, G, hd)
    fp32."""
    table = block_table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    if k_scale is None:
        return paged_attention(q.contiguous(), k_pool, v_pool, table, pos,
                               softcap=softcap)
    return paged_attention_quant(q.contiguous(), k_pool, v_pool, k_scale,
                                 v_scale, table, pos, softcap=softcap)
