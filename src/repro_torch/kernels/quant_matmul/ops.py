"""Entry points of the fused dequant GEMMs, mirroring
``repro/kernels/quant_matmul/ops.py``.

``quant_matmul_op`` (int8 codes) and ``quant_matmul_packed_op`` (2/4-bit
codes packed along K) flatten the leading activation dims, cast to fp32 and
compute ``rowsum(x)`` for the kernels' epilogue; the wrappers then launch
the CUDA kernel for a CUDA tensor or take the plain version for a CPU one.
``quant_matmul_qt`` is the serving dispatcher over a ``QuantizedTensor``.
"""

from __future__ import annotations

import torch

from .quant_matmul import quant_matmul, quant_matmul_packed


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()


def quant_matmul_op(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """y = x @ (codes*scale + bias); x: (..., K), codes: (K, N) int8."""
    x2 = _flatten(x)
    y = quant_matmul(x2, codes, scale, bias, x2.sum(dim=1))
    return y.reshape(*x.shape[:-1], codes.shape[1])


def quant_matmul_packed_op(x: torch.Tensor, packed: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor, *,
                           bits: int, k: int) -> torch.Tensor:
    """Packed twin of ``quant_matmul_op``: packed (ceil(K/per), N) uint8."""
    x2 = _flatten(x)
    y = quant_matmul_packed(x2, packed, scale, bias, x2.sum(dim=1),
                            bits=bits, k=k)
    return y.reshape(*x.shape[:-1], packed.shape[1])


def quant_matmul_qt(x: torch.Tensor, qt, *, act_spec=None) -> torch.Tensor:
    """Serving dispatcher: ``y = x @ dequant(qt)`` off a QuantizedTensor,
    by storage class: int8 codes go to K1, packed 2/4-bit codes to K4.

    Scale and bias arrive per-tensor or per-channel (``(1, N)`` for one
    layer of a per-channel site); the kernels take ``(N,)`` vectors.
    """
    if act_spec is not None:
        raise NotImplementedError(
            "integer activation GEMMs (act_spec) are ported with ROADMAP "
            "queue 1 item 9 (fully-integer GEMMs, kernels K5/K6)")
    n = qt.codes.shape[-1]
    scale = qt.scale.reshape(-1).broadcast_to((n,)).contiguous()
    bias = qt.bias.reshape(-1).broadcast_to((n,)).contiguous()
    if qt.storage_bits == 8:
        return quant_matmul_op(x, qt.codes, scale, bias)
    return quant_matmul_packed_op(x, qt.codes, scale, bias,
                                  bits=qt.storage_bits, k=qt.k)
