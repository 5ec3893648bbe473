"""Wrapper of the K1 CUDA kernel ``csrc/quant_matmul.cu``.

``y = scale * (x @ codes) + bias * rowsum(x)``, which equals
``x @ (codes * scale + bias)``: the card's counterpart of
``repro/kernels/quant_matmul/quant_matmul.py:quant_matmul_pallas``. The
source's header says what bounds it and how the kernel is laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import quant_matmul_ref


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("quant_matmul").quant_matmul_f32_i8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, codes, scale, bias, rowsum):
    m, k = x.shape
    if codes.ndim != 2 or codes.shape[0] != k:
        raise ValueError(f"codes {tuple(codes.shape)} do not match x "
                         f"{tuple(x.shape)}")
    n = codes.shape[1]
    want = ((x, torch.float32, (m, k)), (codes, torch.int8, (k, n)),
            (scale, torch.float32, (n,)), (bias, torch.float32, (n,)),
            (rowsum, torch.float32, (m,)))
    for t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("quant_matmul operands must be contiguous")
    if max(m, n, k) >= 2**31:
        raise ValueError(f"quant_matmul dims must fit int32: {(m, n, k)}")


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, rowsum: torch.Tensor) -> torch.Tensor:
    """x: (M, K) fp32; codes: (K, N) int8; scale/bias: (N,) fp32; rowsum:
    (M,) fp32 ``sum_k x[m, k]``. Returns (M, N) fp32.

    A CPU tensor takes the plain version (``quant_matmul_ref``); a CUDA
    tensor launches the kernel on the current stream, without
    synchronising, and raises if the launch is refused.
    """
    if x.device.type == "cpu":
        return quant_matmul_ref(x, codes, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu or cuda, not {x.device}")
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    _check(x, codes, scale, bias, rowsum)
    m, k = x.shape
    n = codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        with torch.cuda.device(x.device):
            rc = _kernel_fn()(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), rowsum.data_ptr(), out.data_ptr(), m, n, k,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quant_matmul launch failed: CUDA error {rc}")
        quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
