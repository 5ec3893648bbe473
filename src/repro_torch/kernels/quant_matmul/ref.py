"""Plain PyTorch version of the fused dequant GEMM (int8 codes)."""

from __future__ import annotations

import torch


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
