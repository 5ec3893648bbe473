"""Attention: GQA over global (causal) and local (sliding-window) layers,
dense prefill and paged decode, optionally under the engine's window with
sink tokens (DESIGN.md §17).

Counterpart of ``repro/models/attention.py``:

  * ``attention_train`` -- causal attention over a whole (padded) prompt.
    On the card, where no gradient flows (prefill, calibration,
    ``make_act_specs``), its core from the scores to the PV product is K7
    (``flash_attention_op``); elsewhere -- every CPU run, and the training
    forward, whose backward K7 does not have -- it is ``repro``'s two bf16
    einsums with fp32 accumulation, with the same cast points.
  * ``attention_decode_paged`` -- one-token decode through a paged KV pool:
    the new K/V is written into the pool (quantized at the write site for
    an int8/int4 pool), then ``paged_attention_op`` (the K2a or K2b CUDA
    kernel on the card, K2c under a window) attends through the block
    table.

Both resolve each layer's ``(window, sink_tokens)`` from its kind and the
engine's tuple (``window=None``: the architectural mask only) by
``_resolve_window``: a local layer attends ``cfg.window`` positions (and no
more than the engine's window), a global one the whole causal history.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sites import QuantContext
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.paged_attention.ops import paged_attention_op
from repro_torch.quant import kv as kv_codec

from .layers import COMPUTE_DTYPE, apply_rope, qmatmul, softcap

NEG_INF = -1e30


def init_attn(cfg: ModelConfig, *, reps: int, generator, device):
    """Scan-stacked (reps, ...) q/k/v/o weights, ``randn / sqrt(fan_in)``."""
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads

    def w(shape, fan_in):
        return torch.randn((reps,) + shape, generator=generator,
                           device=device) / fan_in ** 0.5

    return {
        "wq": w((d, h * hd), d),
        "wk": w((d, kv * hd), d),
        "wv": w((d, kv * hd), d),
        "wo": w((h * hd, d), h * hd),
    }


def _project_qkv(qc: QuantContext, p, x, cfg: ModelConfig, positions):
    """Shared q/k/v projection + rope. x: (B, S, d)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qmatmul(qc, "attn_q", x, p["wq"]).reshape(b, s, h, hd)
    k = qmatmul(qc, "attn_k", x, p["wk"]).reshape(b, s, kv, hd)
    v = qmatmul(qc, "attn_v", x, p["wv"]).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(t, groups: int):
    """(B, S, KV, hd) -> (B, S, KV*groups, hd)."""
    b, s, kv, hd = t.shape
    return t[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd)


def _resolve_window(window, kind: str, cfg: ModelConfig):
    """The ``(window, sink_tokens)`` of one layer from the engine's tuple
    (``repro``'s ``_resolve_window``): local layers tighten their
    architectural window to ``min(cfg.window, w)`` and drop sinks, global
    layers take the tuple verbatim. ``(None, 0)`` means causal only."""
    if window is None:
        return (cfg.window if kind == "local" else None, 0)
    w, sinks = window
    if kind == "local":
        return (min(cfg.window, w), 0)
    return (w, sinks)


def _flash_prefill(q, k, v) -> bool:
    """Whether K7 takes the attention core: on the card, where no gradient
    flows through q/k/v. ``repro``'s K7 has no backward (no
    ``custom_vjp``), so the port gives it none and the training forward
    keeps the einsums."""
    return q.is_cuda and not (q.requires_grad or k.requires_grad
                              or v.requires_grad)


def attention_train(qc: QuantContext, p, x, cfg: ModelConfig,
                    kind: str = "global", *, positions=None, window=None):
    """Causal attention over a whole sequence; a local layer also masks a
    key unless it lies within ``cfg.window`` of the query, and with the
    engine's ``(window, sink_tokens)`` tuple a key is masked unless it lies
    within that window of the query or among the sinks (``_resolve_window``
    per ``kind``). Returns (y, (k, v)).

    Through K7 (on the card, no gradient) the softmax probabilities stay
    fp32 into the PV product, as in the TPU kernel; ``repro``'s einsums,
    which every other run keeps, round them to bf16 first. K2a set the same
    precedent for decode."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(qc, p, x, cfg, positions)
    eff, sinks = _resolve_window(window, kind, cfg)
    if _flash_prefill(q, k, v):
        # (B, S, H, hd) read through (B, H, S, hd) strides, KV heads shared
        out = flash_attention_op(
            q.to(COMPUTE_DTYPE).transpose(1, 2),
            k.to(COMPUTE_DTYPE).transpose(1, 2),
            v.to(COMPUTE_DTYPE).transpose(1, 2), causal=True, window=eff,
            softcap=cfg.attn_softcap, sinks=sinks).transpose(1, 2)
    else:
        groups = cfg.n_heads // cfg.n_kv_heads
        k_r, v_r = _repeat_kv(k, groups), _repeat_kv(v, groups)
        # bf16 operands, fp32 products and sums (the einsums' preferred
        # type)
        logits = torch.einsum(
            "bqhd,bkhd->bhqk", q.to(COMPUTE_DTYPE).to(torch.float32),
            k_r.to(COMPUTE_DTYPE).to(torch.float32)) * cfg.head_dim ** -0.5
        logits = softcap(logits, cfg.attn_softcap)
        qi = torch.arange(s, device=x.device)[:, None]
        ki = torch.arange(s, device=x.device)[None, :]
        mask = qi >= ki
        if eff is not None:
            in_win = (qi - ki) < eff
            if sinks:
                in_win |= ki < sinks
            mask &= in_win
        logits = torch.where(mask[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(COMPUTE_DTYPE)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32),
                           v_r.to(torch.float32)).to(COMPUTE_DTYPE)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    y = qmatmul(qc, "attn_o", out, p["wo"])
    return qc.act("attn_o", y), (k, v)


def attention_decode_paged(qc: QuantContext, p, x, pool: dict, block_table,
                           pos, cfg: ModelConfig, kind: str = "global", *,
                           write_mask=None, window=None):
    """One-token decode through a paged KV pool.

    ``pool``: {"k", "v"} of (num_blocks, bs, KV, hd), one layer's physical
    block pool, or codes plus ``"k_scale"``/``"v_scale"`` for a quantized
    one (``kv_pool.init_pool``), whose new K/V is quantized here;
    ``block_table``: (B, max_blocks) int32 (-1 = unallocated); ``pos``:
    (B,) int32. The new K/V lands at physical block
    ``table[b, pos // bs]`` offset ``pos % bs``; rows outside
    ``write_mask`` (and rows whose block is unallocated) write to the
    reserved garbage block 0. Unlike ``repro``, which returns a new pool,
    the write is IN PLACE (``index_put_``): the pool is the largest tensor
    of a decode step and copying it per layer per token would dominate.

    Returns (y, pool).
    """
    b = x.shape[0]
    q, k, v = _project_qkv(qc, p, x, cfg, pos[:, None])
    bs = pool["k"].shape[1]
    mb = block_table.shape[1]
    lp = torch.clamp(pos, 0, mb * bs - 1).to(torch.int64)
    rows = torch.arange(b, device=x.device)
    phys = block_table[rows, lp // bs]
    ok = phys >= 0
    if write_mask is not None:
        ok = ok & write_mask.to(torch.bool)
    tgt = torch.where(ok, phys, 0).to(torch.int64)
    off = lp % bs
    spec = kv_codec.spec_from_cache(pool, cfg.head_dim)
    if spec is not None:
        # write-site quantization: codes and group scales land together
        kc, ksc = kv_codec.quantize_kv(k[:, 0], spec)
        vc, vsc = kv_codec.quantize_kv(v[:, 0], spec)
        new = {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc}
        scales = {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]}
    else:
        new = {"k": k[:, 0], "v": v[:, 0]}
        scales = {}
    for name, x in new.items():
        pool[name].index_put_((tgt, off), x.to(pool[name].dtype))

    groups = cfg.n_heads // cfg.n_kv_heads
    qg = q[:, 0].reshape(b, cfg.n_kv_heads, groups, cfg.head_dim)
    eff, sinks = _resolve_window(window, kind, cfg)
    out = paged_attention_op(qg.to(COMPUTE_DTYPE), pool["k"], pool["v"],
                             block_table, pos, window=eff, sinks=sinks,
                             softcap=cfg.attn_softcap, **scales)
    out = out.to(COMPUTE_DTYPE).reshape(b, 1, cfg.n_heads * cfg.head_dim)
    y = qmatmul(qc, "attn_o", out, p["wo"])
    return qc.act("attn_o", y), pool
