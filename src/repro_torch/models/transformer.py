"""Config-driven decoder: dense attention blocks (global, or local sliding
window) with SwiGLU or GeGLU MLPs.

Counterpart of ``repro/models/transformer.py`` for the dense decoders that
``tinyllama-1.1b`` (``("global",)``) and ``gemma2-2b`` (``("local",
"global")`` with attention and logit softcaps, sandwich norms and scaled
embeddings) are. Parameters keep ``repro``'s layout: ``params
["blocks"][pi]`` holds pattern entry ``pi`` with every leaf stacked along a
leading ``R = n_layers // len(block_pattern)`` axis, and where ``repro``
scans over that axis the port runs a Python loop over ``r``; like
``repro``, it runs every layer of entry 0, then every layer of entry 1.
Quantization state for stacked sites is stacked the same way and sliced
per layer (``_layer_qc``), so site keys are ``repro``'s letter for letter
(``p0_global/attn/attn_q.w``, ``head.w``).

Entry points:
  init_params(cfg, seed, device=...)
  collect_sites(cfg) / site_weights(params, cfg)
  forward_train(qc, params, batch, cfg)            -> logits
  prefill_slot(qc, params, tokens, plen, cache, slot, cfg, block_table=...,
               window=...)                         -> logits, cache
  decode_step(qc, params, cache, tokens, cfg, ..., window=...)
                                                   -> logits, cache
  init_paged_cache(cfg, batch, num_blocks, block_size, ...)

Other block kinds (ssm, recurrent), MoE, qk-norm, qkv-bias, M-RoPE and
modality stubs come with ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sites import QuantContext, SiteInfo
from repro_torch.device import resolve_device
from repro_torch.serving import kv_pool

from . import attention as attn
from .layers import COMPUTE_DTYPE, glu_mlp, init_glu_mlp, qmatmul, rms_norm, \
    softcap


def check_supported(cfg: ModelConfig):
    """Reject configs outside the ported decoders: attention blocks (global
    or local) in a pattern that divides the depth, SwiGLU or GeGLU."""
    unported = []
    if not set(cfg.block_pattern) <= {"global", "local"} \
            or cfg.remainder_kinds:
        unported.append(f"block_pattern={cfg.block_pattern} over "
                        f"{cfg.n_layers} layers")
    if cfg.n_experts:
        unported.append("MoE")
    if cfg.mlp not in ("swiglu", "geglu"):
        unported.append(f"mlp={cfg.mlp}")
    for flag in ("qkv_bias", "qk_norm"):
        if getattr(cfg, flag):
            unported.append(flag)
    if cfg.mrope_sections is not None:
        unported.append("M-RoPE")
    if not cfg.embed_input:
        unported.append("embed_input=False")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} is ported with ROADMAP queue "
            f"1 item 14 (other block kinds and archs)")


# ---------------------------------------------------------------------------
# Parameters and sites
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters in ``repro``'s layout from a seeded
    ``torch.Generator`` on ``device`` (``None`` = the card). The numbers
    differ from ``repro``'s ``jax.random`` ones; tests that compare the two
    packages build params in ``repro`` and convert them (``bridge``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    reps = cfg.pattern_repeats
    d = cfg.d_model
    blocks = []
    for _ in cfg.block_pattern:
        block = {
            "ln1": torch.zeros((reps, d), device=dev),
            "attn": attn.init_attn(cfg, reps=reps, generator=gen, device=dev),
            "ln2": torch.zeros((reps, d), device=dev),
            "mlp": init_glu_mlp(d, cfg.d_ff, reps=reps, generator=gen,
                                device=dev),
        }
        if cfg.post_norm:       # gemma2's sandwich norms
            block["ln1_post"] = torch.zeros((reps, d), device=dev)
            block["ln2_post"] = torch.zeros((reps, d), device=dev)
        blocks.append(block)
    params = {"blocks": blocks, "rem": [],
              "final_norm": torch.zeros((d,), device=dev)}
    params["embed"] = torch.randn((cfg.padded_vocab, d), generator=gen,
                                  device=dev) * 0.02
    if not cfg.tie_embeddings:
        params["head"] = torch.randn((d, cfg.padded_vocab), generator=gen,
                                     device=dev) * 0.02
    return params


# (site, (params group, leaf)) per block, in repro's registration order
_BLOCK_SITES = (
    ("attn/attn_q", ("attn", "wq")), ("attn/attn_k", ("attn", "wk")),
    ("attn/attn_v", ("attn", "wv")), ("attn/attn_o", ("attn", "wo")),
    ("ffn/mlp_gate", ("mlp", "w_gate")), ("ffn/mlp_up", ("mlp", "w_up")),
    ("ffn/mlp_down", ("mlp", "w_down")),
)


def _block_weight_shapes(cfg: ModelConfig) -> dict:
    d, hd, h, kv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (h * hd, d), "w_gate": (d, cfg.d_ff),
            "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}


def collect_sites(cfg: ModelConfig) -> dict[str, SiteInfo]:
    """Every matmul site of the model, as ``repro``'s collect-mode trace
    records it (same names, shapes, stack counts and order), listed from
    the config instead of traced."""
    check_supported(cfg)
    shapes = _block_weight_shapes(cfg)
    sites = {}
    for pi, kind in enumerate(cfg.block_pattern):
        for site, (_, leaf) in _BLOCK_SITES:
            name = f"p{pi}_{kind}/{site}"
            k, n = shapes[leaf]
            sites[name] = SiteInfo(
                name=name, weight_shape=(k, n), fan_in=k, out_features=n,
                positions=1, stack=cfg.pattern_repeats, active_frac=1.0,
                act_quantized=True)
    sites["head"] = SiteInfo(
        name="head", weight_shape=(cfg.d_model, cfg.padded_vocab),
        fan_in=cfg.d_model, out_features=cfg.padded_vocab, positions=1,
        stack=1, active_frac=1.0, act_quantized=False)
    return sites


def site_weights(params, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """"<site>.w" -> the site's weight, stacked along the scan axis (what
    ``repro``'s export-mode forward captures). A single-repeat pattern
    entry is unstacked, as ``repro`` applies it without a scan."""
    out = {}
    for pi, kind in enumerate(cfg.block_pattern):
        bp = params["blocks"][pi]
        for site, (group, leaf) in _BLOCK_SITES:
            w = bp[group][leaf]
            out[f"p{pi}_{kind}/{site}.w"] = w if cfg.pattern_repeats > 1 \
                else w[0]
    out["head.w"] = params["head"] if "head" in params else params["embed"].T
    return out


# ---------------------------------------------------------------------------
# Per-layer slices
# ---------------------------------------------------------------------------


def _tree_index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, r) for k, v in tree.items()}
    return tree[r]


def _layer_qc(qc: QuantContext, prefix: str, r: int, stacked: bool):
    """The child context of layer ``r`` of pattern entry ``prefix``: its
    slices of the stacked state over the parent's. Gates, ranges and probes
    are sliced as views, so gradients reach the stacked leaves. Frozen
    serve state is sliced once per (prefix, r) and kept on ``qc``; train
    and calibrate contexts are sliced anew on every forward."""
    key = (prefix, r)
    sub = qc.slices.get(key)
    if sub is not None:
        return sub
    mine = prefix + "/"

    def pick(d, sl):
        return {k: sl(v) for k, v in d.items() if k.startswith(mine)}

    def row(t):
        return t[r] if stacked else t

    def layer(v):
        return v.layer(r) if stacked else v

    sub = qc.child(
        qweights=pick(qc.qweights, layer), specs=pick(qc.specs, layer),
        gates=pick(qc.gates, row), probes=pick(qc.probes, row),
        ranges=pick(qc.ranges, lambda v: {"beta": row(v["beta"]),
                                          "signed": v["signed"]}))
    if qc.mode == "serve":
        qc.slices[key] = sub
    return sub


def _absorb_stats(qc: QuantContext, subs: list, stacked: bool):
    """Per-layer stats of ``subs`` back into ``qc``, stacked to (R, ...)
    for a stacked pattern entry (``repro``'s scan outputs)."""
    def join(vals):
        return torch.stack(vals) if stacked else vals[0]

    for key, st in subs[0].act_stats.items():
        qc.act_stats[key] = {s: join([c.act_stats[key][s] for c in subs])
                             for s in st}
    for key in subs[0].weight_stats:
        qc.weight_stats[key] = join([c.weight_stats[key] for c in subs])


def _layers(qc: QuantContext, params, cache, cfg: ModelConfig):
    """Yield (child qc, block params, cache entry, prefix, kind) per layer,
    in ``repro``'s order: every layer of pattern entry 0, then entry 1."""
    reps = cfg.pattern_repeats
    for pi, kind in enumerate(cfg.block_pattern):
        prefix = f"p{pi}_{kind}"
        for r in range(reps):
            lc = {name: t[r] for name, t in cache["layers"][pi].items()}
            yield (_layer_qc(qc, prefix, r, reps > 1),
                   _tree_index(params["blocks"][pi], r), lc, prefix, kind)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _embed(qc: QuantContext, params, batch, cfg: ModelConfig):
    h = params["embed"][batch].to(COMPUTE_DTYPE)
    if cfg.scale_embed:
        # gemma2: times sqrt(d_model) rounded to bf16, a product rounded to
        # bf16; a Python scalar, so a decode tick copies nothing to the card
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE).item()
    return qc.input(h).to(COMPUTE_DTYPE)


def _head(qc: QuantContext, params, h, cfg: ModelConfig):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["head"] if "head" in params else params["embed"].T
    logits = qmatmul(qc, "head", h, w).to(torch.float32)
    logits = softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _post_norm(bp, name: str, y, cfg: ModelConfig):
    """gemma2's sandwich norm on a sublayer's output (``ln1_post`` after
    attention, ``ln2_post`` after the MLP); the identity elsewhere."""
    return rms_norm(y, bp[name], cfg.norm_eps) if cfg.post_norm else y


def _apply_block_full(qc, bp, h, cfg: ModelConfig, kind: str, *, positions,
                      window=None):
    """Full-sequence block. Returns (h, (k, v)) with k/v in bf16."""
    resid = h
    hn = rms_norm(h, bp["ln1"], cfg.norm_eps)
    with qc.scope("attn"):
        y, (k, v) = attn.attention_train(qc, bp["attn"], hn, cfg, kind,
                                         positions=positions, window=window)
    h = resid + _post_norm(bp, "ln1_post", y, cfg).to(resid.dtype)
    resid = h
    hn = rms_norm(h, bp["ln2"], cfg.norm_eps)
    with qc.scope("ffn"):
        y = glu_mlp(qc, bp["mlp"], hn, cfg.mlp)
    h = resid + _post_norm(bp, "ln2_post", y, cfg).to(resid.dtype)
    return h, (k.to(COMPUTE_DTYPE), v.to(COMPUTE_DTYPE))


def _apply_block_decode(qc, bp, h, pool, pos, cfg: ModelConfig, kind: str,
                        *, block_table, write_mask, window=None):
    resid = h
    hn = rms_norm(h, bp["ln1"], cfg.norm_eps)
    with qc.scope("attn"):
        y, _ = attn.attention_decode_paged(
            qc, bp["attn"], hn, pool, block_table, pos, cfg, kind,
            write_mask=write_mask, window=window)
    h = resid + _post_norm(bp, "ln1_post", y, cfg).to(resid.dtype)
    resid = h
    hn = rms_norm(h, bp["ln2"], cfg.norm_eps)
    with qc.scope("ffn"):
        y = glu_mlp(qc, bp["mlp"], hn, cfg.mlp)
    return resid + _post_norm(bp, "ln2_post", y, cfg).to(resid.dtype)


def _require_paged(block_table):
    if block_table is None:
        raise NotImplementedError(
            "the contiguous (ring) KV layout is ported with ROADMAP queue 1 "
            "item 10; pass a block_table (paged layout)")


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def forward_train(qc: QuantContext, params, batch, cfg: ModelConfig):
    """Full-sequence forward over ``batch`` ((B, S) int tokens) ->
    logits (B, S, V) fp32.

    In train mode every weight and output activation is fake-quantized
    (``qc.weight``/``qc.act``), and ``qc.act_stats``/``qc.weight_stats``
    come back stacked to (R, ...) under ``repro``'s keys; in calibrate
    mode ``qc.act_stats`` holds the range statistics. Where ``repro`` scans
    (and rematerialises) the layers, the port loops over them and keeps
    their activations for the backward.
    """
    check_supported(cfg)
    h = _embed(qc, params, batch, cfg)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    reps = cfg.pattern_repeats
    for pi, kind in enumerate(cfg.block_pattern):
        prefix = f"p{pi}_{kind}"
        subs = []
        for r in range(reps):
            sub = _layer_qc(qc, prefix, r, reps > 1)
            with sub.scope(prefix):
                h, _ = _apply_block_full(
                    sub, _tree_index(params["blocks"][pi], r), h, cfg, kind,
                    positions=positions)
            subs.append(sub)
        _absorb_stats(qc, subs, reps > 1)
    return _head(qc, params, h, cfg)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def prefill_slot(qc: QuantContext, params, tokens, plen: int, cache, slot: int,
                 cfg: ModelConfig, *, block_table=None, start_blk: int = 0,
                 window=None):
    """Batched prefill for one serving slot through the paged cache.

    ``tokens``: (1, S_pad) int, right-padded; ``plen`` the real length. Runs
    the whole padded prompt through one causal forward (each layer under
    the engine's ``(window, sink_tokens)`` tuple ``window`` as its kind
    resolves it, DESIGN.md §17; on the card through K7), scatters each
    layer's K/V into the pools at the physical ids of the slot's table row
    (``kv_pool.write_prompt_blocks``, blocks below ``start_blk`` skipped),
    and sets the slot's pos to ``plen``. The pools and ``cache["pos"]`` are
    updated IN PLACE (``repro`` returns a new cache). Returns
    (logits (1, S_pad, V), cache); the slot's first token is
    ``argmax(logits[0, plen - 1])``.
    """
    _require_paged(block_table)
    h = _embed(qc, params, tokens, cfg)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    row = block_table[slot]
    bs = cache["layers"][0]["k"].shape[-3]
    nblk = -(-plen // bs)
    for sub, bp, pool, prefix, kind in _layers(qc, params, cache, cfg):
        with sub.scope(prefix):
            h, (k, v) = _apply_block_full(sub, bp, h, cfg, kind,
                                          positions=positions, window=window)
        kv_pool.write_prompt_blocks(pool, k[0], v[0], row, start_blk, nblk,
                                    bs)
    cache["pos"][slot] = plen
    return _head(qc, params, h, cfg), cache


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, *, kv_dtype=torch.bfloat16,
                     kv_spec=None, device=None):
    """Decode cache with paged attention layers: per pattern entry a pool
    ``(R, num_blocks, bs, KV, hd)`` addressed through the engine's block
    table, plus the per-row ``pos`` vector. ``kv_spec`` (a
    ``quant.kv.KVQuantSpec``) makes the pools quantized: codes plus fp16
    group scales, each stacked the same way."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = []
    for _ in cfg.block_pattern:
        one = kv_pool.init_pool(cfg, num_blocks, block_size, dtype=kv_dtype,
                                spec=kv_spec, device=dev)
        layers.append({name: torch.stack([t] * cfg.pattern_repeats)
                       for name, t in one.items()})
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": layers}


def decode_step(qc: QuantContext, params, cache, tokens, cfg: ModelConfig, *,
                advance=None, block_table=None, window=None):
    """One decode step for the whole batch. tokens: (B,) int.

    ``cache["pos"]`` is per row, so slots decode at independent positions.
    ``advance`` ((B,) bool/int) selects which rows bump their position;
    rows that do not advance write their K/V to the garbage block. Each
    layer attends under the engine's ``(window, sink_tokens)`` tuple
    ``window`` as its kind resolves it (``None``: causal, and local layers
    within ``cfg.window``). The pools are written IN PLACE; the returned
    cache carries a new ``pos``.
    Returns (logits (B, 1, V), cache).
    """
    _require_paged(block_table)
    pos = cache["pos"]
    write_mask = None if advance is None else advance.to(torch.bool)
    h = _embed(qc, params, tokens[:, None], cfg)
    for sub, bp, pool, prefix, kind in _layers(qc, params, cache, cfg):
        with sub.scope(prefix):
            h = _apply_block_decode(sub, bp, h, pool, pos, cfg, kind,
                                    block_table=block_table,
                                    write_mask=write_mask, window=window)
    logits = _head(qc, params, h, cfg)
    adv = 1 if advance is None else advance.to(pos.dtype)
    return logits, {"pos": pos + adv, "layers": cache["layers"]}
