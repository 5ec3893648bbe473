"""Plain PyTorch version of the fused fake-quant kernel.

Mirrors ``repro/kernels/fake_quant/ref.py``: bits = T(max(g, 0.5)),
alpha = -beta (signed) or 0, b >= 32 passes through, fp32 internally.
"""

from __future__ import annotations

import torch

from repro_torch.core.gates import gate_to_bits
from repro_torch.core.quantizer import quantize


def fake_quant_ref(x2: torch.Tensor, gate: torch.Tensor, beta: torch.Tensor,
                   signed: bool) -> torch.Tensor:
    """x2: (M, N) fp32 or bf16; gate/beta: (N,) per column (broadcast by
    the caller). Returns x2's dtype."""
    return quantize(x2, gate_to_bits(gate)[None, :], beta[None, :], signed)
