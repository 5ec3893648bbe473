"""Plain PyTorch version: single-token GQA decode through a paged KV pool
(float or quantized pool, optionally under a sliding window with sinks)."""

from __future__ import annotations

import torch

from repro_torch.quant.kv import dequant_codes, unpack_int4

NEG_INF = -1e30


def _dequant_gathered(codes, scale, hd):
    """(B, S, KV, packed) codes + (B, S, KV, ng) scales -> (B, S, KV, hd)
    fp32."""
    if codes.dtype == torch.uint8:  # nibble-packed int4
        codes = unpack_int4(codes, hd)
    return dequant_codes(codes, scale, hd, hd // scale.shape[-1])


def paged_attention_ref(q, k_pool, v_pool, block_table, pos, *,
                        window: int | None = None, sinks: int = 0,
                        softcap: float | None = None, k_scale=None,
                        v_scale=None) -> torch.Tensor:
    """q: (B, KV, G, hd); pools: (num_blocks, bs, KV, hd) float, or
    (num_blocks, bs, KV, packed_head) codes with ``k_scale``/``v_scale``
    (num_blocks, bs, KV, ng) fp16; block_table: (B, max_blocks) int (-1 =
    unallocated); pos: (B,) int. Returns (B, KV, G, hd) fp32.

    Mirrors ``repro/kernels/paged_attention/ref.py:paged_attention_ref``:
    gather every table entry (-1 gathers the garbage block 0, whose
    positions lie past ``pos`` or, evicted, outside the window, and are
    masked); a quantized pool gathers codes and scales through the same
    entries and dequantizes right after the gather; then scores from q and
    K in q's dtype with fp32 accumulation, mask ``col <= pos`` and, with a
    ``window``, ``pos - col < window or col < sinks`` (DESIGN.md §17),
    fp32 softmax, and the probabilities are cast to q's dtype before the
    PV product.
    """
    b, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    mb = block_table.shape[1]
    safe = torch.where(block_table >= 0, block_table, 0).long()
    k = k_pool[safe].reshape(b, mb * bs, kvh, k_pool.shape[-1])
    v = v_pool[safe].reshape(b, mb * bs, kvh, v_pool.shape[-1])
    if k_scale is not None:
        ng = k_scale.shape[-1]
        k = _dequant_gathered(k, k_scale[safe].reshape(b, mb * bs, kvh, ng),
                              hd)
        v = _dequant_gathered(v, v_scale[safe].reshape(b, mb * bs, kvh, ng),
                              hd)
    # operands rounded to q's dtype, products and sums in fp32
    qf = q.to(torch.float32)
    kf = k.to(q.dtype).to(torch.float32)
    vf = v.to(q.dtype).to(torch.float32)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, kf) * hd ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    valid = attended(pos, mb * bs, window, sinks)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype).to(torch.float32)
    return torch.einsum("bkgs,bskd->bkgd", probs, vf)


def attended(pos, length: int, window: int | None = None,
             sinks: int = 0) -> torch.Tensor:
    """(B, length) bool: which key positions each row's query at ``pos``
    attends, ``kp <= p and (p - kp < window or kp < sinks)``."""
    kp = torch.arange(length, device=pos.device)[None, :]
    p = pos.to(torch.int64)[:, None]
    valid = kp <= p
    if window is not None:
        valid &= ((p - kp) < window) | (kp < sinks)
    return valid


def bf16_rounding_tolerance(q, k, v, block_table, pos, *,
                            window: int | None = None,
                            sinks: int = 0) -> float:
    """How far ``paged_attention_ref`` may lie from a kernel that keeps K,
    V and the probabilities in fp32 (K2b, like the TPU kernel), for
    dequantized pools ``k``/``v`` (num_blocks, bs, KV, hd) fp32.

    The plain version rounds K, V and the probabilities to q's dtype
    (bf16). Rounding V and the probabilities moves the output by at most
    2^-9 max|v| each. Rounding K moves each score s = hd^-0.5 q.k by at
    most 2^-9 S, where S is the largest hd^-0.5 sum_d |q_d k_d| over the
    attended tokens, and a score shift of e moves a softmax average of v by
    at most 2 e max|v|. So the bound is 2^-8 max|v| (1 + S), plus 1e-5 of
    fp32 noise.
    """
    b, kvh, g, hd = q.shape
    bs = k.shape[1]
    mb = block_table.shape[1]
    safe = torch.where(block_table >= 0, block_table, 0).long()
    kg = k[safe].reshape(b, mb * bs, kvh, hd).to(torch.float32).abs()
    s = torch.einsum("bkgd,bskd->bkgs", q.to(torch.float32).abs(), kg)
    live = attended(pos, mb * bs, window, sinks)
    s = torch.where(live[:, None, None, :], s, 0.0)
    s_max = float(s.max()) * hd ** -0.5
    return 2.0 ** -8 * float(v.abs().max()) * (1.0 + s_max) + 1e-5
