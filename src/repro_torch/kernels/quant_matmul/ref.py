"""Plain PyTorch versions of the fused dequant GEMM (int8 and packed)."""

from __future__ import annotations

import torch

from repro_torch.quant.pack import unpack_codes


def quant_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x: (M, K) fp; codes: (K, N) int8; scale/bias: (N,).

    ``y = x @ (codes * scale + bias)`` computed in fp32 (mirrors
    ``repro/kernels/quant_matmul/ref.py:quant_matmul_ref``). On the card the
    caller keeps ``torch.backends.cuda.matmul.allow_tf32`` False so this
    stays a full-fp32 product.
    """
    w = codes.to(torch.float32) * scale[None, :] + bias[None, :]
    return x.to(torch.float32) @ w


def quant_matmul_packed_ref(x: torch.Tensor, packed: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor, *,
                            bits: int, k: int) -> torch.Tensor:
    """Packed version: ``unpack_codes`` then ``quant_matmul_ref``, so the
    packed path is bit for bit the int8 path on the unpacked codes (mirrors
    ``repro/kernels/quant_matmul/ref.py:quant_matmul_packed_ref``)."""
    return quant_matmul_ref(x, unpack_codes(packed, bits, k), scale, bias)
