"""Gate variables (paper §2.1, Eqs. 2-4).

Counterpart of ``repro/core/gates.py``. A gate ``g`` is a free real
variable; ``T(g)`` (Eq. 4) maps it onto a bit-width in {0, 2, 4, 8, 16,
32}; the binary gates ``G_b(g) = [T(g) >= b]`` assemble the quantized value
from the residual decomposition (Eq. 3), which telescopes to
``Q(x, T(g))``. ``gated_fake_quant`` is that telescoped form, one rounding
pass, and its forward is the K3 kernel (``kernels.fake_quant``) on the
card; ``residual_fake_quant`` keeps the paper's literal chain as the
reference. Gates are clamped to ``[GATE_MIN, GATE_MAX]`` after every
update (no pruning).
"""

from __future__ import annotations

import torch

from .quantizer import fake_quant, fq_bwd

# Paper: gates below 0.5 are reset to 0.5 (no pruning), so T(g) >= 2.
GATE_MIN = 0.5
# Initial gate value (paper §4.2): T(5.5) = 32-bit at the start of training.
GATE_INIT = 5.5
# Upper clamp: everything above 4 is 32-bit already; capping keeps
# cost-free gates from drifting far and slows oscillation.
GATE_MAX = 6.0

# Bit-width levels of Eq. 2, plus the base 2.
LEVELS = (2, 4, 8, 16, 32)

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


def gate_fn(g, b: int) -> torch.Tensor:
    """``G_b(g) = 1[T(g) >= b]`` (binary gate of Eq. 3)."""
    return (transform(g) >= b).to(torch.float32)


def gate_to_bits(g) -> torch.Tensor:
    """Bit-width implied by a (clamped) gate. Minimum is 2 (no pruning)."""
    return transform(torch.clamp_min(torch.as_tensor(g, dtype=torch.float32),
                                     GATE_MIN))


def clamp_gate(g: torch.Tensor) -> torch.Tensor:
    return torch.clamp(g, GATE_MIN, GATE_MAX)


class _GatedFakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, beta, signed):
        # imported here: the kernel's plain version imports this module
        from repro_torch.kernels.fake_quant.ops import fake_quant_op

        ctx.save_for_backward(x, g, beta)
        ctx.signed = signed
        return fake_quant_op(x, g, beta, signed)

    @staticmethod
    def backward(ctx, ct):
        x, g, beta = ctx.saved_tensors
        with torch.profiler.record_function("fake_quant_backward"):
            dx, dbeta = fq_bwd(x, gate_to_bits(g), beta, ctx.signed, ct,
                               want_dbeta=ctx.needs_input_grad[2])
        return dx, None, dbeta, None


def gated_fake_quant(x: torch.Tensor, g, beta, signed: bool) -> torch.Tensor:
    """Fake quantization at bit-width ``T(g)`` (telescoped Eq. 3).

    Forward: ``kernels.fake_quant.ops.fake_quant_op`` (K3 for a CUDA
    tensor, its plain version for a CPU one). Backward: ``fq_bwd`` at
    ``bits = T(g)``; the gate gets no gradient. ``g`` and ``beta`` are
    per-tensor or per-channel (broadcasting along x's last axis);
    per-weight gates raise ``NotImplementedError``.
    """
    g = torch.as_tensor(g, dtype=torch.float32, device=x.device)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
    return _GatedFakeQuant.apply(x, g, beta, signed)


def residual_fake_quant(x: torch.Tensor, g, beta, signed: bool):
    """Paper-literal Eq. 3: the explicit residual chain with binary gates.

    The reference form (``QuantConfig.impl='residual'``), equal to
    ``gated_fake_quant``. As in ``repro``, the fp32 binary gates promote
    the chain to fp32 whatever x's dtype.
    """
    g = torch.clamp_min(torch.as_tensor(g, dtype=torch.float32,
                                        device=x.device), GATE_MIN)
    xs = {b: fake_quant(x, float(b), beta, signed) for b in LEVELS}
    eps = {b: (xs[b] - xs[b // 2]).to(torch.float32) for b in LEVELS[1:]}
    acc = gate_fn(g, 32) * eps[32]
    acc = gate_fn(g, 16) * (eps[16] + acc)
    acc = gate_fn(g, 8) * (eps[8] + acc)
    acc = gate_fn(g, 4) * (eps[4] + acc)
    # G2 is always 1 after clamping (no pruning): the chain is Q(x, T(g))
    return gate_fn(g, 2) * (xs[2].to(torch.float32) + acc)
