"""Entry points of the fused dequant GEMM, mirroring
``repro/kernels/quant_matmul/ops.py``.

``quant_matmul_op`` flattens the leading activation dims, casts to fp32 and
computes ``rowsum(x)`` for the kernel's epilogue; the wrapper then launches
the CUDA kernel for a CUDA tensor or takes the plain version for a CPU one.
``quant_matmul_qt`` is the serving dispatcher over a ``QuantizedTensor``.
"""

from __future__ import annotations

import torch

from .quant_matmul import quant_matmul


def quant_matmul_op(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """y = x @ (codes*scale + bias); x: (..., K), codes: (K, N) int8."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1]).to(torch.float32).contiguous()
    rowsum = x2.sum(dim=1)
    y = quant_matmul(x2, codes, scale, bias, rowsum)
    return y.reshape(*orig[:-1], codes.shape[1])


def quant_matmul_qt(x: torch.Tensor, qt, *, act_spec=None) -> torch.Tensor:
    """Serving dispatcher: ``y = x @ dequant(qt)`` off a QuantizedTensor.

    Scale and bias arrive per-tensor or per-channel (``(1, N)`` for one
    layer of a per-channel site); the kernel takes ``(N,)`` vectors.
    """
    if act_spec is not None:
        raise NotImplementedError(
            "integer activation GEMMs (act_spec) are ported with ROADMAP "
            "queue 1 item 9 (fully-integer GEMMs, kernels K5/K6)")
    if qt.storage_bits != 8:
        raise NotImplementedError(
            f"packed {qt.storage_bits}-bit codes are ported with ROADMAP "
            f"queue 1 item 7 (mixed sub-byte weights, kernel K4)")
    n = qt.codes.shape[-1]
    scale = qt.scale.reshape(-1).broadcast_to((n,)).contiguous()
    bias = qt.bias.reshape(-1).broadcast_to((n,)).contiguous()
    return quant_matmul_op(x, qt.codes, scale, bias)
