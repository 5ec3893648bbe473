"""Wrappers of the K1 and K4 CUDA kernels ``csrc/quant_matmul.cu``.

``y = scale * (x @ codes) + bias * rowsum(x)``, which equals
``x @ (codes * scale + bias)``. ``quant_matmul`` (K1, int8 codes) is the
card's counterpart of ``repro/kernels/quant_matmul/quant_matmul.py:
quant_matmul_pallas``; ``quant_matmul_packed`` (K4, 2/4-bit codes packed
along K by ``quant/pack.py``) that of ``quant_matmul_packed_pallas``. The
source's header says what bounds them and how the kernels are laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from repro_torch.quant.pack import packed_rows

from .ref import quant_matmul_packed_ref, quant_matmul_ref


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("quant_matmul").quant_matmul_f32_i8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _packed_kernel_fn():
    fn = _build.load("quant_matmul").quant_matmul_f32_packed
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, codes, scale, bias, rowsum, *, bits: int = 8):
    """Device, dtype, shape and contiguity of the operands. ``bits`` 8:
    int8 codes (K, N); 2 or 4: uint8 codes (ceil(K/per), N)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    rows = k if bits == 8 else packed_rows(k, bits)
    if codes.ndim != 2 or codes.shape[0] != rows:
        raise ValueError(f"codes {tuple(codes.shape)} do not match x "
                         f"{tuple(x.shape)} at {bits} bits")
    n = codes.shape[1]
    code_dtype = torch.int8 if bits == 8 else torch.uint8
    want = ((x, torch.float32, (m, k)), (codes, code_dtype, (rows, n)),
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


def quant_matmul_packed(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        rowsum: torch.Tensor, *, bits: int,
                        k: int) -> torch.Tensor:
    """x: (M, K) fp32; packed: (ceil(K/per), N) uint8 ``bits``-bit codes
    (``quant/pack.py`` layout); scale/bias: (N,) fp32; rowsum: (M,) fp32;
    ``k`` the logical fan-in (x's K). Returns (M, N) fp32.

    A CPU tensor takes the plain version (``quant_matmul_packed_ref``); a
    CUDA tensor launches K4 on the current stream, without synchronising,
    and raises if the launch is refused.
    """
    if bits not in (2, 4):
        raise ValueError(f"quant_matmul_packed takes 2 or 4 bits, got {bits}")
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not have K = {k}")
    if x.device.type == "cpu":
        return quant_matmul_packed_ref(x, packed, scale, bias, bits=bits,
                                       k=k)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul_packed runs on cpu or cuda, not "
                         f"{x.device}")
    _check(x, packed, scale, bias, rowsum, bits=bits)
    m = x.shape[0]
    n = packed.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        with torch.cuda.device(x.device):
            rc = _packed_kernel_fn()(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), rowsum.data_ptr(), out.data_ptr(), m, n, k,
                bits, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quant_matmul_packed launch failed: CUDA "
                               f"error {rc}")
        quant_matmul_packed.launches += 1
    return out


quant_matmul_packed.launches = 0
