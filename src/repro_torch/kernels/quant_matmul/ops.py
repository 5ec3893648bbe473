"""Entry points of the fused dequant and integer GEMMs, mirroring
``repro/kernels/quant_matmul/ops.py``.

``quant_matmul_op`` (int8 codes) and ``quant_matmul_packed_op`` (2/4-bit
codes packed along K) flatten the leading activation dims, cast to fp32 and
compute ``rowsum(x)`` for the kernels' epilogue; the wrappers then launch
the CUDA kernel for a CUDA tensor or take the plain version for a CPU one.

``int_matmul_op`` / ``int_matmul_packed_op`` (DESIGN.md §16) quantize the
activation per tensor (``quantize_to_int``), and fold the activation grid
``(sx, bx)`` and the weight's per-channel ``(scale, bias)`` into
``eff_scale = sx*scale``, ``eff_bias = sx*bias`` and
``const = bx*(scale*colsum + K*bias)``, so the int32 GEMM of the codes
equals ``(qx*sx + bx) @ (codes*scale + bias)`` up to fp32 epilogue rounding.
``quant_matmul_qt`` is the serving dispatcher over a ``QuantizedTensor``.

The serving path folds those vectors once per site and layer
(``int_gemm_plan``, the same fp32 operations, so the same bits) and
``int_gemm`` then hands K5/K6 the fp32 activations: the kernel quantizes
them and takes their row sums itself.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantizer import affine_grid, quantize_to_int

from .quant_matmul import (int_matmul, int_matmul_packed, quant_matmul,
                           quant_matmul_packed)


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


def _fold(scale, bias, colsum, sx, bx, k: int):
    """(eff_scale, eff_bias, const) of the integer GEMM, in ``repro``'s
    order of fp32 operations."""
    return (sx * scale, sx * bias,
            bx * (scale * colsum.to(torch.float32) + k * bias))


def int_matmul_op(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, colsum: torch.Tensor,
                  act_beta: torch.Tensor, *, act_bits: int,
                  act_signed: bool = True) -> torch.Tensor:
    """Integer entry point: quantize ``x`` per tensor, int8 x int8 GEMM.

    ``x``: (..., K) float; ``codes``: (K, N) int8 weight codes with their
    per-channel ``scale``/``bias`` (N,) and int32 K-sums ``colsum`` (N,).
    Returns (..., N) fp32, equal in exact arithmetic to
    ``fake_quant(x) @ (codes*scale + bias)``.
    """
    k = x.shape[-1]
    qx, sx, bx = quantize_to_int(x.reshape(-1, k), act_bits, act_beta,
                                 act_signed)
    rowsum = qx.to(torch.int32).sum(dim=1).to(torch.float32)
    eff_scale, eff_bias, const = _fold(scale, bias, colsum, sx, bx, k)
    y = int_matmul(qx.contiguous(), codes, eff_scale, eff_bias, rowsum,
                   const)
    return y.reshape(*x.shape[:-1], codes.shape[1])


def int_matmul_packed_op(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         colsum: torch.Tensor, act_beta: torch.Tensor, *,
                         bits: int, k: int, act_bits: int,
                         act_signed: bool = True) -> torch.Tensor:
    """Packed twin of ``int_matmul_op``: 2/4-bit weight codes decoded to
    int8 in the kernel, the same per-tensor activation quantization."""
    qx, sx, bx = quantize_to_int(x.reshape(-1, x.shape[-1]), act_bits,
                                 act_beta, act_signed)
    rowsum = qx.to(torch.int32).sum(dim=1).to(torch.float32)
    eff_scale, eff_bias, const = _fold(scale, bias, colsum, sx, bx, k)
    y = int_matmul_packed(qx.contiguous(), packed, eff_scale, eff_bias,
                          rowsum, const, bits=bits, k=k)
    return y.reshape(*x.shape[:-1], packed.shape[1])


def _site_vectors(qt):
    """A site's per-channel scale, bias and colsum as (N,) vectors (they
    arrive per tensor or per channel, ``(1, N)`` for one layer)."""
    n = qt.codes.shape[-1]
    return tuple(t.reshape(-1).broadcast_to((n,)).contiguous()
                 for t in (qt.scale, qt.bias, qt.code_colsum()))


@dataclasses.dataclass
class IntGemmPlan:
    """One site's integer GEMM with every constant folded: the weight's
    codes (int8 or packed), ``eff_scale``/``eff_bias``/``const`` (N,) and
    the activation grid ``[alpha, beta, s]`` at ``act_bits``. Depends only
    on the frozen export and the frozen ``.in`` spec."""

    codes: torch.Tensor
    storage_bits: int
    k: int
    eff_scale: torch.Tensor
    eff_bias: torch.Tensor
    const: torch.Tensor
    grid: torch.Tensor
    act_bits: int


def int_gemm_plan(qt, act_spec) -> IntGemmPlan:
    """Fold ``qt`` (one layer's ``QuantizedTensor``) and ``act_spec`` (its
    per-tensor ``ActQuantSpec``) into an ``IntGemmPlan`` with the
    operations ``int_matmul_op`` runs on every call, so ``int_gemm`` gives
    its bits."""
    scale, bias, colsum = _site_vectors(qt)
    beta = torch.clamp_min(torch.as_tensor(
        act_spec.beta, dtype=torch.float32, device=scale.device).reshape(()),
        1e-8)
    alpha = -beta if act_spec.signed else torch.zeros_like(beta)
    sx, bx = affine_grid(act_spec.bits, beta, act_spec.signed)
    eff_scale, eff_bias, const = _fold(scale, bias, colsum, sx, bx, qt.k)
    return IntGemmPlan(codes=qt.codes, storage_bits=qt.storage_bits, k=qt.k,
                       eff_scale=eff_scale, eff_bias=eff_bias, const=const,
                       grid=torch.stack([alpha, beta, sx]),
                       act_bits=int(act_spec.bits))


def int_gemm(x: torch.Tensor, plan: IntGemmPlan) -> torch.Tensor:
    """``y = fake_quant(x) @ dequant(qt)`` by the integer GEMM of ``plan``:
    x (..., K) -> (..., N) fp32. K5 (int8 codes) or K6 (packed) quantizes
    the fp32 activations itself; a CPU tensor takes the plain versions."""
    x2 = _flatten(x)
    act = (plan.grid, plan.act_bits)
    if plan.storage_bits == 8:
        y = int_matmul(x2, plan.codes, plan.eff_scale, plan.eff_bias, None,
                       plan.const, act=act)
    else:
        y = int_matmul_packed(x2, plan.codes, plan.eff_scale, plan.eff_bias,
                              None, plan.const, bits=plan.storage_bits,
                              k=plan.k, act=act)
    return y.reshape(*x.shape[:-1], plan.codes.shape[-1])


def quant_matmul_qt(x: torch.Tensor, qt, *, act_spec=None) -> torch.Tensor:
    """Serving dispatcher: ``y = x @ dequant(qt)`` off a QuantizedTensor,
    by storage class: int8 codes go to K1, packed 2/4-bit codes to K4.

    With ``act_spec`` (a per-tensor ``ActQuantSpec``) the activation is
    quantized and the integer GEMMs run instead: K5 for int8 codes, K6 for
    packed ones (DESIGN.md §16).

    Scale and bias arrive per-tensor or per-channel (``(1, N)`` for one
    layer of a per-channel site); the kernels take ``(N,)`` vectors.
    """
    if act_spec is not None:
        scale, bias, colsum = _site_vectors(qt)
        act_beta = torch.as_tensor(act_spec.beta, dtype=torch.float32,
                                   device=scale.device).reshape(())
        if qt.storage_bits == 8:
            return int_matmul_op(x, qt.codes, scale, bias, colsum, act_beta,
                                 act_bits=act_spec.bits,
                                 act_signed=act_spec.signed)
        return int_matmul_packed_op(
            x, qt.codes, scale, bias, colsum, act_beta,
            bits=qt.storage_bits, k=qt.k, act_bits=act_spec.bits,
            act_signed=act_spec.signed)
    n = qt.codes.shape[-1]
    scale = qt.scale.reshape(-1).broadcast_to((n,)).contiguous()
    bias = qt.bias.reshape(-1).broadcast_to((n,)).contiguous()
    if qt.storage_bits == 8:
        return quant_matmul_op(x, qt.codes, scale, bias)
    return quant_matmul_packed_op(x, qt.codes, scale, bias,
                                  bits=qt.storage_bits, k=qt.k)
