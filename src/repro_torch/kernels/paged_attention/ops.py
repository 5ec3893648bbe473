"""Entry point of paged decode attention, mirroring
``repro/kernels/paged_attention/ops.py:paged_attention_op`` for float pools
without a window."""

from __future__ import annotations

import torch

from .paged_attention import paged_attention


def paged_attention_op(q, k_pool, v_pool, block_table, pos, *,
                       softcap: float | None = None) -> torch.Tensor:
    """q: (B, KV, G, hd); pools: (num_blocks, bs, KV, hd) bf16/fp32;
    block_table: (B, max_blocks); pos: (B,) -> (B, KV, G, hd) fp32."""
    return paged_attention(
        q.contiguous(), k_pool, v_pool,
        block_table.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), softcap=softcap)
