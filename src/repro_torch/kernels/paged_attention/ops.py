"""Entry point of paged decode attention, mirroring
``repro/kernels/paged_attention/ops.py:paged_attention_op``: a float pool
goes to K2a, a quantized pool (``k_scale``/``v_scale`` given) to K2b, and
either under a ``window`` (with ``sinks``, DESIGN.md §17) to K2c."""

from __future__ import annotations

import torch

from .paged_attention import (paged_attention, paged_attention_quant,
                              paged_attention_quant_window,
                              paged_attention_window)


def paged_attention_op(q, k_pool, v_pool, block_table, pos, *,
                       window: int | None = None, sinks: int = 0,
                       softcap: float | None = None, k_scale=None,
                       v_scale=None) -> torch.Tensor:
    """q: (B, KV, G, hd); pools: (num_blocks, bs, KV, hd) bf16/fp32, or
    integer codes with ``k_scale``/``v_scale`` (num_blocks, bs, KV, ng) fp16
    group scales; block_table: (B, max_blocks); pos: (B,) -> (B, KV, G, hd)
    fp32. ``window``/``sinks`` (tokens) restrict each row to key positions
    ``kp <= pos`` with ``pos - kp < window or kp < sinks``."""
    table = block_table.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    q = q.contiguous()
    if k_scale is None:
        if window is None:
            return paged_attention(q, k_pool, v_pool, table, pos,
                                   softcap=softcap)
        return paged_attention_window(q, k_pool, v_pool, table, pos,
                                      window=window, sinks=sinks,
                                      softcap=softcap)
    if window is None:
        return paged_attention_quant(q, k_pool, v_pool, k_scale, v_scale,
                                     table, pos, softcap=softcap)
    return paged_attention_quant_window(q, k_pool, v_pool, k_scale, v_scale,
                                        table, pos, window=window,
                                        sinks=sinks, softcap=softcap)
