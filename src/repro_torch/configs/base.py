"""Model + shape configuration dataclasses and the architecture registry."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    qkv_bias: bool = False
    qk_norm: bool = False
    # layer-kind pattern cycled over depth: 'global' | 'local' | 'recurrent' | 'ssm'
    block_pattern: tuple[str, ...] = ("global",)
    window: int = 4096
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE (sums to head_dim/2)
    post_norm: bool = False        # gemma2 sandwich norms
    scale_embed: bool = False      # gemma2 multiplies embeddings by sqrt(d)
    # --- MLP ---
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    dense_residual: bool = False   # arctic: dense MLP parallel to MoE
    moe_group: int = 1024          # capacity-dispatch token group size
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_kernel: int = 4
    # --- RG-LRU (recurrentgemma / griffin) ---
    lru_width: int = 0
    # --- embeddings / io ---
    tie_embeddings: bool = True
    embed_input: bool = True       # False: modality stub — forward takes embeddings
    norm_eps: float = 1e-6
    vocab_pad_multiple: int = 256

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def pattern_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder_kinds(self) -> tuple[str, ...]:
        rem = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    def layer_kinds(self) -> list[str]:
        p = len(self.block_pattern)
        return [self.block_pattern[i % p] for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        for kind in self.layer_kinds():
            if kind in ("global", "local"):
                qkv = d * hd * (self.n_heads + 2 * self.n_kv_heads)
                o = self.n_heads * hd * d
                n += qkv + o
                if self.qkv_bias:
                    n += hd * (self.n_heads + 2 * self.n_kv_heads)
                n += 2 * d  # norms
                n += self._mlp_params()
            elif kind == "ssm":
                din, st, h = self.d_inner, self.ssm_state, self.ssm_heads
                proj_in = d * (2 * din + 2 * st + h)
                n += proj_in + din * d  # in/out proj
                n += self.conv_kernel * (din + 2 * st)  # depthwise conv
                n += 3 * h + din + d  # A_log, D, dt_bias, gated norm, ln
            elif kind == "recurrent":
                w = self.lru_width
                n += d * w * 2 + w * d  # x/y branches + out
                n += 2 * w * w + 3 * w  # gates + lambda + conv-ish
                n += self.conv_kernel * w + d
                n += self._mlp_params()  # hybrid blocks keep their MLP
        n += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        n += d  # final norm
        return n

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.n_experts:
            e = self.n_experts * 3 * d * self.moe_dff + d * self.n_experts
            if self.dense_residual:
                e += 3 * d * self.d_ff
            return e
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(1 for k in self.layer_kinds() if k in ("global", "local"))
        per_layer_moe = self.n_experts * 3 * self.d_model * self.moe_dff
        active = self.top_k * 3 * self.d_model * self.moe_dff
        return full - moe_layers * (per_layer_moe - active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs with a sub-quadratic long-context mechanism run long_500k (DESIGN.md §6).
LONG_CONTEXT_OK = {"gemma2-2b", "mamba2-1.3b", "mixtral-8x22b", "recurrentgemma-2b"}


def flops_per_token_train(cfg: ModelConfig, seq_len: int) -> float:
    """6*N_active*D-style estimate plus attention term, per token."""
    n = cfg.active_param_count()
    base = 6.0 * n
    # attention: 12 * L_attn * H * hd * seq (fwd+bwd, causal halves it)
    attn_layers = sum(1 for k in cfg.layer_kinds() if k in ("global", "local"))
    base += 12.0 * attn_layers * cfg.n_heads * cfg.head_dim * seq_len / 2
    return base


def tokens_per_batch(shape: ShapeConfig) -> int:
    if shape.kind == "decode":
        return shape.global_batch
    return shape.global_batch * shape.seq_len


def hbm_param_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> float:
    return cfg.param_count() * dtype_bytes


def fmt_count(n: float) -> str:
    for unit, div in (("T", 1e12), ("B", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(n) >= div:
            return f"{n/div:.2f}{unit}"
    return str(n)
