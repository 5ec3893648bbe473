"""Gate variables (paper §2.1, Eqs. 2-4): the gate -> bit-width map.

Counterpart of ``repro/core/gates.py``, reduced to what serving needs:
``transform`` (Eq. 4) and ``gate_to_bits`` (with the no-pruning clamp).
"""

from __future__ import annotations

import torch

# Paper: gates below 0.5 are reset to 0.5 (no pruning), so T(g) >= 2.
GATE_MIN = 0.5

# Thresholds of T (Eq. 4): g in (k-1, k] -> bits; g > 4 -> 32.
_T_EDGES = (0.0, 1.0, 2.0, 3.0, 4.0)
_T_BITS = (0.0, 2.0, 4.0, 8.0, 16.0, 32.0)


def transform(g) -> torch.Tensor:
    """``T(g)`` (Eq. 4): piecewise-constant map from gate to bit-width."""
    g = torch.as_tensor(g, dtype=torch.float32)
    bits = torch.full_like(g, _T_BITS[0])
    for edge, b in zip(_T_EDGES, _T_BITS[1:]):
        bits = torch.where(g > edge, torch.full_like(g, b), bits)
    return bits


def gate_to_bits(g) -> torch.Tensor:
    """Bit-width implied by a (clamped) gate. Minimum is 2 (no pruning)."""
    return transform(torch.clamp_min(torch.as_tensor(g, dtype=torch.float32),
                                     GATE_MIN))
