"""Plain PyTorch version: single-token GQA decode through a paged KV pool
(float pool, no window)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pool, v_pool, block_table, pos, *,
                        softcap: float | None = None) -> torch.Tensor:
    """q: (B, KV, G, hd); pools: (num_blocks, bs, KV, hd) float;
    block_table: (B, max_blocks) int (-1 = unallocated); pos: (B,) int.
    Returns (B, KV, G, hd) fp32.

    Mirrors ``repro/kernels/paged_attention/ref.py:paged_attention_ref``:
    gather every table entry (-1 gathers the garbage block 0, whose
    positions lie past ``pos`` and are masked), scores from q and K in q's
    dtype with fp32 accumulation, mask ``col <= pos``, fp32 softmax, then
    the probabilities are cast to q's dtype before the PV product.
    """
    b, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    mb = block_table.shape[1]
    safe = torch.where(block_table >= 0, block_table, 0).long()
    k = k_pool[safe].reshape(b, mb * bs, kvh, hd)
    v = v_pool[safe].reshape(b, mb * bs, kvh, hd)
    # operands rounded to q's dtype, products and sums in fp32
    qf = q.to(torch.float32)
    kf = k.to(q.dtype).to(torch.float32)
    vf = v.to(q.dtype).to(torch.float32)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, kf) * hd ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    sids = torch.arange(mb * bs, device=q.device)[None, :]
    valid = sids <= pos.to(torch.int64)[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype).to(torch.float32)
    return torch.einsum("bkgs,bskd->bkgd", probs, vf)
