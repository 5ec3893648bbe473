"""KV-cache quantization codec (DESIGN.md §14).

Counterpart of ``repro/quant/kv.py``. A ``KVQuantSpec`` describes how one
attention layer stores its K/V vectors: ``bits`` (8 or 4) integer codes
with symmetric per-group absmax scales along head_dim, one fp16 scale per
``group_size`` contiguous head elements.

The codec contract is ``repro``'s, bit for bit:

  * ``scale = max(absmax / qmax, SCALE_FLOOR)`` computed in fp32, rounded
    to fp16 and widened back before the divide, so the codec is exactly
    idempotent: ``quantize(dequantize(x)) == (codes, scale)``;
  * codes round half to even (``torch.round``, like ``jnp.round``) and clip
    to ``[-qmax, qmax]``;
  * a ragged head tail is zero-padded inside the codec (the engine requires
    ``head_dim % group_size == 0``, so the kernel never sees one);
  * int4 codes are packed two per byte along head_dim with ``pack.py``'s
    layout: byte ``i`` holds code ``2i`` in the low nibble and ``2i+1`` in
    the high one, biased by +8.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .pack import pack_codes

# fp16 scales: half the aux bytes of fp32.
SCALE_DTYPE = torch.float16
# fp16-normal scale floor: all-zero / denormal groups land on a fixed grid,
# so requantization recovers the identical scale bit for bit.
SCALE_FLOOR = 1e-4

_QMAX = {8: 127, 4: 7}
_CODE_DTYPE = {8: torch.int8, 4: torch.uint8}  # 4-bit stores packed bytes


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Storage spec for one attention layer's quantized KV cache."""

    bits: int = 8
    group_size: int = 32
    head_dim: int = 64

    def __post_init__(self):
        if self.bits not in _QMAX:
            raise ValueError(f"KV bits must be one of {sorted(_QMAX)}, "
                             f"got {self.bits}")
        if self.group_size <= 0 or self.head_dim <= 0:
            raise ValueError("group_size and head_dim must be positive")

    @property
    def qmax(self) -> int:
        return _QMAX[self.bits]

    @property
    def num_groups(self) -> int:
        return -(-self.head_dim // self.group_size)

    @property
    def padded_head(self) -> int:
        return self.num_groups * self.group_size

    @property
    def packed_head(self) -> int:
        """Trailing axis of the stored codes (bytes per vector)."""
        return self.head_dim if self.bits == 8 else -(-self.head_dim // 2)

    @property
    def code_dtype(self) -> torch.dtype:
        return _CODE_DTYPE[self.bits]

    @property
    def scale_dtype(self) -> torch.dtype:
        return SCALE_DTYPE

    def bytes_per_vector(self) -> int:
        """Device bytes of ONE K or V head vector: codes + fp16 scales."""
        return self.packed_head + self.aux_bytes_per_vector()

    def aux_bytes_per_vector(self) -> int:
        return self.num_groups * _itemsize(SCALE_DTYPE)


def quantize_kv(x: torch.Tensor, spec: KVQuantSpec):
    """Quantize float K/V vectors ``(..., head_dim)``.

    Returns ``(codes, scale)``: codes ``(..., packed_head)`` in
    ``spec.code_dtype`` (int4 packed two per byte), scale ``(..., ng)``
    fp16.
    """
    if x.shape[-1] != spec.head_dim:
        raise ValueError(f"vectors of {x.shape[-1]} elements, spec {spec}")
    lead = tuple(x.shape[:-1])
    xf = x.to(torch.float32)
    pad = spec.padded_head - spec.head_dim
    if pad:
        xf = F.pad(xf, (0, pad))
    g = xf.reshape(lead + (spec.num_groups, spec.group_size))
    absmax = g.abs().amax(dim=-1)
    # a tensor divisor: on the card, a Python scalar divisor would become a
    # multiply by its reciprocal, which rounds differently
    qmax = torch.full_like(absmax, float(spec.qmax))
    scale = torch.clamp_min(absmax / qmax, SCALE_FLOOR).to(SCALE_DTYPE)
    s32 = scale.to(torch.float32)
    codes = torch.clamp(torch.round(g / s32[..., None]), -spec.qmax,
                        spec.qmax)
    codes = codes.reshape(lead + (spec.padded_head,))[..., :spec.head_dim]
    codes = codes.to(torch.int8)
    if spec.bits == 4:
        codes = pack_codes(codes[..., None], 4)[..., 0]
    return codes, scale


def unpack_int4(packed: torch.Tensor, head_dim: int) -> torch.Tensor:
    """uint8 ``(..., ceil(hd/2))`` -> centered int32 codes ``(..., hd)``:
    low nibble first, bias +8."""
    p = packed.to(torch.int32)
    c = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1)
    c = c.reshape(*p.shape[:-1], p.shape[-1] * 2)
    return c[..., :head_dim] - 8


def dequant_codes(codes: torch.Tensor, scale: torch.Tensor, head_dim: int,
                  group_size: int) -> torch.Tensor:
    """Centered int codes ``(..., hd)`` + scales ``(..., ng)`` -> fp32:
    code x scale per group of ``group_size`` contiguous elements."""
    ng = scale.shape[-1]
    padded = ng * group_size
    c = codes.to(torch.float32)
    if padded != head_dim:
        c = F.pad(c, (0, padded - head_dim))
    g = c.reshape(*c.shape[:-1], ng, group_size)
    out = g * scale.to(torch.float32)[..., None]
    return out.reshape(*c.shape[:-1], padded)[..., :head_dim]


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  spec: KVQuantSpec) -> torch.Tensor:
    """Inverse of ``quantize_kv``: fp32 ``(..., head_dim)``."""
    if spec.bits == 4:
        codes = unpack_int4(codes, spec.head_dim)
    return dequant_codes(codes, scale, spec.head_dim, spec.group_size)


def spec_from_cache(entry: dict, head_dim: int) -> KVQuantSpec | None:
    """The spec of a cache/pool entry, or None for a float one.

    Quantized entries carry ``"k_scale"`` beside ``"k"``; bits come from
    the codes dtype (int8 -> 8, packed uint8 -> 4), the group size from the
    scales' trailing axis. Valid for engine-built caches, whose
    ``head_dim`` is a multiple of the group size.
    """
    if not isinstance(entry, dict) or "k_scale" not in entry:
        return None
    bits = 8 if entry["k"].dtype == torch.int8 else 4
    ng = entry["k_scale"].shape[-1]
    if head_dim % ng:
        raise ValueError(f"head_dim {head_dim} is not a multiple of {ng} "
                         f"scale groups")
    return KVQuantSpec(bits=bits, group_size=head_dim // ng,
                       head_dim=head_dim)


# ---------------------------------------------------------------------------
# Footprint accounting (DESIGN.md §14)
# ---------------------------------------------------------------------------


def bytes_per_cached_token(kv_heads: int, head_dim: int, *,
                           spec: KVQuantSpec | None = None,
                           dtype=torch.bfloat16) -> int:
    """Device bytes ONE attention layer holds per cached token (K + V):
    packed codes plus fp16 scales, or ``2 * kv_heads * head_dim *
    itemsize`` for a float pool."""
    if spec is not None:
        if spec.head_dim != head_dim:
            raise ValueError(f"spec {spec} for head_dim {head_dim}")
        return 2 * kv_heads * spec.bytes_per_vector()
    return 2 * kv_heads * head_dim * _itemsize(dtype)


def kv_cache_report(kinds: list[str], kv_heads: int, head_dim: int, *,
                    spec: KVQuantSpec | None = None,
                    dtype=torch.bfloat16, kv_dtype: str = "bf16") -> dict:
    """Bytes per cached token, per attention layer and in total, against
    bf16 and fp32 pools of the same geometry (``kinds``: the model's
    per-layer mixer list; only "global"/"local" layers hold KV)."""
    attn = [(i, k) for i, k in enumerate(kinds) if k in ("global", "local")]
    per = {f"{i}:{k}": bytes_per_cached_token(kv_heads, head_dim,
                                              spec=spec, dtype=dtype)
           for i, k in attn}
    total = sum(per.values())
    bf16 = len(attn) * bytes_per_cached_token(kv_heads, head_dim,
                                              dtype=torch.bfloat16)
    fp32 = len(attn) * bytes_per_cached_token(kv_heads, head_dim,
                                              dtype=torch.float32)
    aux = (2 * kv_heads * spec.aux_bytes_per_vector() * len(attn)
           if spec is not None else 0)
    return {
        "kv_dtype": kv_dtype,
        "bits": spec.bits if spec is not None else None,
        "group_size": spec.group_size if spec is not None else None,
        "kv_heads": kv_heads,
        "head_dim": head_dim,
        "attention_layers": len(attn),
        "per_layer": per,
        "bytes_per_cached_token": total,
        "bytes_aux_per_token": aux,
        "bf16_bytes_per_cached_token": bf16,
        "fp32_bytes_per_cached_token": fp32,
        "vs_bf16": total / max(bf16, 1),
        "vs_fp32": total / max(fp32, 1),
    }
