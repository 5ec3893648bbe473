"""Architecture registry: the 10 assigned configs + reduced smoke variants.

Every entry is exact per the assignment table (sources noted inline).
``get_config(name)`` returns the full config; ``get_smoke_config(name)``
returns a reduced same-family variant for CPU tests. Individual
``configs/<id>.py`` modules re-export each config for --arch loading.
"""

from __future__ import annotations

import dataclasses

from .base import LONG_CONTEXT_OK, SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_REGISTRY: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- dense LM family -------------------------------------------------------

QWEN15_110B = _register(ModelConfig(
    # [hf:Qwen/Qwen1.5-110B] 80L d8192 64H GQA(kv=8) ff49152 v152064, QKV bias
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064, qkv_bias=True, mlp="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=False,
))

GEMMA2_2B = _register(ModelConfig(
    # [arXiv:2408.00118] 26L d2304 8H GQA(kv=4) ff9216 v256000,
    # local+global alternating, logit softcap, sandwich norms
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000, mlp="geglu",
    block_pattern=("local", "global"), window=4096,
    logit_softcap=30.0, attn_softcap=50.0, post_norm=True, scale_embed=True,
))

TINYLLAMA_1B = _register(ModelConfig(
    # [arXiv:2401.02385] 22L d2048 32H GQA(kv=4) ff5632 v32000
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000, mlp="swiglu",
))

QWEN3_4B = _register(ModelConfig(
    # [hf:Qwen/Qwen3-4B] 36L d2560 32H GQA(kv=8) ff9728 v151936, qk-norm
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936, qk_norm=True, mlp="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=True,
))

# --- SSM ---------------------------------------------------------------------

MAMBA2_1B = _register(ModelConfig(
    # [arXiv:2405.21060] 48L d2048 attn-free v50280, SSD state=128
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280, block_pattern=("ssm",),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64, conv_kernel=4,
))

# --- VLM (backbone; patch frontend stubbed) ----------------------------------

QWEN2VL_72B = _register(ModelConfig(
    # [arXiv:2409.12191] 80L d8192 64H GQA(kv=8) ff29568 v152064, M-RoPE
    name="qwen2-vl-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, qkv_bias=True, mlp="swiglu",
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    embed_input=False, tie_embeddings=False,
))

# --- MoE ----------------------------------------------------------------------

MIXTRAL_8X22B = _register(ModelConfig(
    # [arXiv:2401.04088] 56L d6144 48H GQA(kv=8) ff16384, 8 experts top-2, SWA
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768, mlp="swiglu",
    block_pattern=("local",), window=4096,
    n_experts=8, top_k=2, moe_dff=16384, tie_embeddings=False,
))

ARCTIC_480B = _register(ModelConfig(
    # [hf:Snowflake/snowflake-arctic-base] 35L d7168 56H GQA(kv=8) ff4864,
    # MoE 128 experts top-2 + dense residual
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000, mlp="swiglu",
    n_experts=128, top_k=2, moe_dff=4864, dense_residual=True,
    tie_embeddings=False,
))

# --- audio (decoder over EnCodec tokens; frontend stubbed) --------------------

MUSICGEN_LARGE = _register(ModelConfig(
    # [arXiv:2306.05284] 48L d2048 32H (kv=32: MHA) ff8192 v2048
    name="musicgen-large", family="dense",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, mlp="gelu",
    embed_input=False, tie_embeddings=False,
))

# --- hybrid ---------------------------------------------------------------------

RECURRENTGEMMA_2B = _register(ModelConfig(
    # [arXiv:2402.19427] 26L d2560 10H (kv=1: MQA) ff7680 v256000,
    # RG-LRU + local attn at 1:2 (pattern R,R,A; 26 = 8*3 + 2 remainder)
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, mlp="geglu",
    block_pattern=("recurrent", "recurrent", "local"), window=2048,
    lru_width=2560, conv_kernel=4, scale_embed=True,
))

ALL_ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_smoke_config(name[: -len("-smoke")])
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, few layers/experts."""
    cfg = _REGISTRY[name]
    heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = max(1, min(cfg.n_kv_heads, heads // 2)) if cfg.n_kv_heads else 0
    pat_len = len(cfg.block_pattern)
    # two pattern repeats, plus a remainder layer if the full config has one
    n_layers = pat_len * 2 + (1 if cfg.n_layers % pat_len else 0)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=277,  # deliberately not a multiple of the pad
        window=8,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_dff=64 if cfg.moe_dff else 0,
        moe_group=32,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else 0,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
        vocab_pad_multiple=32,
    )


def shape_cells(arch: str) -> list[str]:
    """The dry-run shape names applicable to this arch (DESIGN.md §6)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_OK:
        cells.append("long_500k")
    return cells
