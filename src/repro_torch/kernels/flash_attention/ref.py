"""Plain PyTorch version: causal (optionally sliding-window) attention over
a whole sequence, GQA by repeated KV heads."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(s: int, *, causal: bool = True, window: int | None = None,
                   sinks: int = 0, device=None) -> torch.Tensor:
    """(S, S) bool: query p keeps key kp iff (not causal or kp <= p) and,
    with a ``window``, ``p - kp < window or kp < sinks`` (DESIGN.md §17;
    ``repro``'s ``attention_train`` mask)."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        in_win = (qi - ki) < window
        if sinks:
            in_win |= ki < sinks
        mask &= in_win
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        sinks: int = 0) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, S, D) with Hq % Hkv == 0 ->
    (B, Hq, S, D) in q's dtype.

    ``repro``'s ``flash_attention_op(use_pallas=False)``: KV heads repeated
    to Hq, then ``ref.py:attention_ref`` on fp32 operands -- logits scaled
    by hd**-0.5, ``tanh`` softcap, the mask of ``attention_mask`` filled
    with -1e30, fp32 softmax, fp32 PV product -- cast to q's dtype. With
    ``sinks=0`` it is the TPU kernel's function.
    """
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * q.shape[-1] ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    mask = attention_mask(q.shape[2], causal=causal, window=window,
                          sinks=sinks, device=q.device)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
