"""Plain PyTorch version: causal (optionally sliding-window) attention over
a whole sequence, GQA by repeated KV heads."""

from __future__ import annotations

import torch

NEG_INF = -1e30

# K7's tolerances against this plain version, which computes the same fp32
# function (scores, softmax statistics, probabilities and PV sums in fp32)
# with its sums in another order: fp32 outputs within 1e-4 of max|v|, a
# wide margin over fp32 reassociation across up to 4608 keys that a mask,
# tile or head-indexing fault (an error of order max|v|) still breaks;
# bf16 outputs, each side rounding its own fp32 result, within one bf16
# ulp of the output plus 1e-5 of max|v|.
K7_F32_RTOL, K7_BF16_RTOL = 1e-4, 1e-5


def k7_tolerance(want: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Elementwise fp32 bound on |K7 - ``want``|, where ``want`` is this
    plain version's output on the same operands and ``v`` their values:
    K7_F32_RTOL of max|v| for fp32, one bf16 ulp of ``want`` plus
    K7_BF16_RTOL of max|v| for bf16."""
    vmax = float(v.float().abs().max())
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
        return K7_BF16_RTOL * vmax \
            + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return torch.full(want.shape, K7_F32_RTOL * vmax, dtype=torch.float32,
                      device=want.device)


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
