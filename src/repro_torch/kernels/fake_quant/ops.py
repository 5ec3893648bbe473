"""Entry point of the fused fake-quant kernel, mirroring
``repro/kernels/fake_quant/ops.py``.

``fake_quant_op`` flattens ``x`` to (M, N) over its last axis, broadcasts a
per-tensor or per-channel gate and range to (N,), and restores the shape;
the wrapper then launches the CUDA kernel for a CUDA tensor or takes the
plain version for a CPU one. ``repro`` casts x to fp32 around its kernel;
the CUDA kernel reads and writes bf16 itself, with the same result.
"""

from __future__ import annotations

import torch

from .fake_quant import fake_quant


def _per_column(a, n: int, like: torch.Tensor) -> torch.Tensor:
    a = torch.as_tensor(a, dtype=torch.float32, device=like.device)
    if not (a.numel() == 1 or (a.numel() == n and a.shape[-1] == n)):
        raise NotImplementedError(
            f"fake_quant_op takes a per-tensor or per-channel gate/range "
            f"(one value, or one per column of the last axis), got shape "
            f"{tuple(a.shape)} for x {tuple(like.shape)}; per-weight "
            f"granularity is ported with ROADMAP queue 1 item 3")
    return a.reshape(-1).expand(n).contiguous()


def fake_quant_op(x: torch.Tensor, gate, beta, signed: bool) -> torch.Tensor:
    """Fake-quantize ``x`` at bit-width T(gate) with range ``beta``.

    gate/beta: scalar (per-tensor) or broadcasting along x's last axis
    (per-channel). fp32 and bf16 ``x`` go to the kernel as they are, any
    other float through fp32; the result has ``x``'s shape and dtype.
    """
    n = x.shape[-1]
    x2 = x.reshape(-1, n)
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.to(torch.float32)
    out = fake_quant(x2.contiguous(), _per_column(gate, n, x),
                     _per_column(beta, n, x), signed)
    return out.reshape(x.shape).to(x.dtype)
