"""Wrappers of the K1, K4, K5 and K6 CUDA kernels ``csrc/quant_matmul.cu``.

``y = scale * (x @ codes) + bias * rowsum(x)``, which equals
``x @ (codes * scale + bias)``. ``quant_matmul`` (K1, int8 codes) is the
card's counterpart of ``repro/kernels/quant_matmul/quant_matmul.py:
quant_matmul_pallas``; ``quant_matmul_packed`` (K4, 2/4-bit codes packed
along K by ``quant/pack.py``) that of ``quant_matmul_packed_pallas``.

``y = eff_scale * (qx @ codes) + eff_bias * rowsum(qx) + const`` with the
product of int8 activation and weight codes summed in int32:
``int_matmul`` (K5) is the counterpart of ``int_matmul_pallas``,
``int_matmul_packed`` (K6) of ``int_matmul_packed_pallas``. Each also
takes fp32 activations with their per-tensor grid (``act``) and quantizes
them in the kernel, as the serving path does. The source's header says
what bounds the kernels and how they are laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from repro_torch.quant.pack import packed_rows

from .ref import (int_matmul_packed_ref, int_matmul_ref,
                  quant_matmul_packed_ref, quant_matmul_ref,
                  quantize_act_ref)


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


@functools.lru_cache(maxsize=None)
def _int_kernel_fn(bits: int):
    lib = _build.load("quant_matmul")
    if bits == 8:
        fn = lib.int_matmul_i8
        tail = [ctypes.c_int] * 3
    else:
        fn = lib.int_matmul_packed_u8
        tail = [ctypes.c_int] * 4
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int, ctypes.c_void_p] + tail + [ctypes.c_void_p]
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


def _check_int(x, codes, eff_scale, eff_bias, rowsum, const, act, *,
               bits: int, k: int):
    """Operands of K5/K6: ``x`` int8 codes with fp32 ``rowsum``, or with
    ``act = (grid, act_bits)`` fp32 activations and no rowsum."""
    if x.ndim != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}), got {tuple(x.shape)}")
    m = x.shape[0]
    rows = k if bits == 8 else packed_rows(k, bits)
    if codes.ndim != 2 or codes.shape[0] != rows:
        raise ValueError(f"codes {tuple(codes.shape)} do not match K = {k} "
                         f"at {bits} bits")
    n = codes.shape[1]
    want = [(codes, torch.int8 if bits == 8 else torch.uint8, (rows, n)),
            (eff_scale, torch.float32, (n,)), (eff_bias, torch.float32, (n,)),
            (const, torch.float32, (n,))]
    if act is None:
        want += [(x, torch.int8, (m, k)), (rowsum, torch.float32, (m,))]
    else:
        grid, act_bits = act
        if rowsum is not None:
            raise ValueError("with act the kernel takes the row sums itself")
        if not 2 <= act_bits <= 8:
            raise ValueError(f"act_bits must be in [2, 8], got {act_bits}")
        want += [(x, torch.float32, (m, k)), (grid, torch.float32, (3,))]
    for t, dtype, shape in want:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("int_matmul operands must be contiguous")
    if max(m, n, k) >= 2**31:
        raise ValueError(f"int_matmul dims must fit int32: {(m, n, k)}")


def _int_launch(wrapper, x, codes, eff_scale, eff_bias, rowsum, const, act,
                *, bits: int, k: int) -> torch.Tensor:
    """Check, launch K5 (``bits`` 8) or K6 on the current stream without
    synchronising, count the launch; raise if it was refused."""
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not "
                         f"{x.device}")
    _check_int(x, codes, eff_scale, eff_bias, rowsum, const, act, bits=bits,
               k=k)
    m, n = x.shape[0], codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        grid, act_bits = act if act is not None else (None, 0)
        tail = (m, n, k) if bits == 8 else (m, n, k, bits)
        with torch.cuda.device(x.device):
            rc = _int_kernel_fn(bits)(
                x.data_ptr(), int(act is not None), codes.data_ptr(),
                eff_scale.data_ptr(), eff_bias.data_ptr(),
                None if rowsum is None else rowsum.data_ptr(),
                const.data_ptr(), None if grid is None else grid.data_ptr(),
                act_bits, out.data_ptr(), *tail,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA "
                               f"error {rc}")
        wrapper.launches += 1
    return out


def int_matmul(qx: torch.Tensor, codes: torch.Tensor,
               eff_scale: torch.Tensor, eff_bias: torch.Tensor,
               rowsum: torch.Tensor | None, const: torch.Tensor, *,
               act=None) -> torch.Tensor:
    """K5. qx: (M, K) int8 activation codes; codes: (K, N) int8;
    eff_scale/eff_bias/const: (N,) fp32; rowsum: (M,) fp32 row sums of
    qx. Returns (M, N) fp32.

    ``act = (grid, act_bits)``: ``qx`` is then (M, K) fp32 activations,
    quantized on ``grid = [alpha, beta, s]`` (fp32 (3,)) at ``act_bits``
    inside the kernel, which also takes their row sums; ``rowsum`` is None.

    A CPU tensor takes the plain version (``quantize_act_ref`` with
    ``act``, then ``int_matmul_ref``); a CUDA tensor launches the kernel on
    the current stream, without synchronising, and raises if the launch is
    refused.
    """
    if qx.device.type == "cpu":
        if act is not None:
            qx, rowsum = quantize_act_ref(qx, *act)
        return int_matmul_ref(qx, codes, eff_scale, eff_bias, rowsum, const)
    return _int_launch(int_matmul, qx, codes, eff_scale, eff_bias, rowsum,
                       const, act, bits=8, k=qx.shape[-1])


int_matmul.launches = 0


def int_matmul_packed(qx: torch.Tensor, packed: torch.Tensor,
                      eff_scale: torch.Tensor, eff_bias: torch.Tensor,
                      rowsum: torch.Tensor | None, const: torch.Tensor, *,
                      bits: int, k: int, act=None) -> torch.Tensor:
    """K6: ``int_matmul`` over (ceil(K/per), N) uint8 ``bits``-bit codes
    (``quant/pack.py`` layout), ``k`` the logical fan-in (qx's K).

    A CPU tensor takes the plain version (``int_matmul_packed_ref``); a
    CUDA tensor launches K6 on the current stream, without synchronising,
    and raises if the launch is refused.
    """
    if bits not in (2, 4):
        raise ValueError(f"int_matmul_packed takes 2 or 4 bits, got {bits}")
    if qx.shape[-1] != k:
        raise ValueError(f"qx {tuple(qx.shape)} does not have K = {k}")
    if qx.device.type == "cpu":
        if act is not None:
            qx, rowsum = quantize_act_ref(qx, *act)
        return int_matmul_packed_ref(qx, packed, eff_scale, eff_bias, rowsum,
                                     const, bits=bits, k=k)
    return _int_launch(int_matmul_packed, qx, packed, eff_scale, eff_bias,
                       rowsum, const, act, bits=bits, k=k)


int_matmul_packed.launches = 0
