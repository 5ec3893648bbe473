"""Plain PyTorch versions of the fused dequant GEMMs (K1 int8, K4 packed)
and of the integer GEMMs (K5 int8, K6 packed; DESIGN.md §16)."""

from __future__ import annotations

import torch

from repro_torch.quant.pack import unpack_codes

# K1's and K4's tolerance against their plain versions, elementwise, as a
# fraction of |x| @ |w| (w = codes * scale + bias): the kernels reassociate
# an fp32 sum of up to K = 9216 terms (scale * sum(x * codes) + bias *
# rowsum against x @ w; split-K partials; the tensor cores' fp32
# accumulation once a k16 slice). Rounding errors of random sign grow like
# sqrt(K) eps32 ~ 1e-5 of that magnitude; even errors of one sign in every
# one of the K / 16 accumulations of the wgmma path stay under
# (K / 16) eps32 ~ 3.4e-5; fp32 x enters the tensor cores as two bf16
# terms, which leaves at most 2^-18 |x| (~3.8e-6) an element. A wrong index,
# nibble or split (an error of order |x| @ |w|) still fails by far.
K1_RTOL = 1e-4


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


def int_accumulate(qx: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``qx @ codes`` of int8 codes, (M, K) x (K, N) -> (M, N) int32.

    Taken as an fp64 GEMM of the codes, which is exact: each product is at
    most 2^14 in magnitude and a sum of K of them stays far below 2^53, so
    every partial sum is an integer fp64 holds exactly, in any order.
    (``torch.matmul`` has no int32 kernel on the card.)
    """
    acc = qx.to(torch.float64) @ codes.to(torch.float64)
    return acc.to(torch.int32)


def int_matmul_ref(qx: torch.Tensor, codes: torch.Tensor,
                   eff_scale: torch.Tensor, eff_bias: torch.Tensor,
                   rowsum: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
    """qx: (M, K) int8 activation codes; codes: (K, N) int8 weight codes;
    eff_scale/eff_bias/const: (N,) fp32; rowsum: (M,) fp32.

    ``eff_scale * (qx @ codes) + eff_bias * rowsum + const`` with the GEMM
    summed exactly in int32 and the epilogue in fp32, in that order (mirrors
    ``repro/kernels/quant_matmul/ref.py:int_matmul_ref``).
    """
    acc = int_accumulate(qx, codes)
    return (acc.to(torch.float32) * eff_scale[None, :]
            + rowsum[:, None] * eff_bias[None, :] + const[None, :])


def int_matmul_packed_ref(qx: torch.Tensor, packed: torch.Tensor,
                          eff_scale: torch.Tensor, eff_bias: torch.Tensor,
                          rowsum: torch.Tensor, const: torch.Tensor, *,
                          bits: int, k: int) -> torch.Tensor:
    """Packed version: ``unpack_codes`` then ``int_matmul_ref``, so packed
    integer serving is bit for bit the int8 integer path on the unpacked
    codes (mirrors ``repro/kernels/quant_matmul/ref.py:
    int_matmul_packed_ref``)."""
    return int_matmul_ref(qx, unpack_codes(packed, bits, k), eff_scale,
                          eff_bias, rowsum, const)


def quantize_act_ref(x: torch.Tensor, grid: torch.Tensor, bits: int):
    """Per-tensor activation codes and their row sums: ``x`` (M, K) fp32
    on the grid ``grid = [alpha, beta, s]`` (``ops.int_gemm_plan``).
    Returns ``(qx (M, K) int8, rowsum (M,) fp32)``; ``qx`` is
    ``core.quantizer.quantize_to_int``'s codes, computed in the same
    order: clip, subtract alpha, divide by s, round half to even, take
    off 2^(bits-1)."""
    alpha, beta, s = grid[0], grid[1], grid[2]
    raw = torch.round((torch.minimum(torch.maximum(x, alpha), beta) - alpha)
                      / s)
    qx = (raw - float(1 << (bits - 1))).to(torch.int8)
    return qx, qx.to(torch.int32).sum(dim=1).to(torch.float32)
