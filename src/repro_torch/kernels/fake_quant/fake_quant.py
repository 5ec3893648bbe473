"""Wrapper of the K3 CUDA kernel ``csrc/fake_quant.cu``.

Fused gated fake quantization of an (M, N) tensor with one gate and one
range per column: the card's counterpart of ``repro/kernels/fake_quant/
fake_quant.py:fake_quant_pallas``. The source's header says what bounds it
and how it is laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import fake_quant_ref


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("fake_quant").fake_quant
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x2, gate, beta):
    if x2.ndim != 2:
        raise ValueError(f"x must be (M, N), got {tuple(x2.shape)}")
    m, n = x2.shape
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fake_quant takes fp32 or bf16 x, got {x2.dtype}")
    for t in (gate, beta):
        if t.device != x2.device:
            raise ValueError(f"operands on {t.device} and {x2.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"expected float32 ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not (x2.is_contiguous() and gate.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("fake_quant operands must be contiguous")
    if max(m, n) >= 2**31:
        raise ValueError(f"fake_quant dims must fit int32: {(m, n)}")


def fake_quant(x2: torch.Tensor, gate: torch.Tensor, beta: torch.Tensor,
               signed: bool) -> torch.Tensor:
    """x2: (M, N) fp32 or bf16; gate/beta: (N,) fp32. Returns x2's dtype.

    A CPU tensor takes the plain version (``fake_quant_ref``); a CUDA
    tensor launches the kernel on the current stream, without
    synchronising, and raises if the launch is refused.
    """
    if x2.device.type == "cpu":
        return fake_quant_ref(x2, gate, beta, signed)
    if x2.device.type != "cuda":
        raise ValueError(f"fake_quant runs on cpu or cuda, not {x2.device}")
    _check(x2, gate, beta)
    m, n = x2.shape
    out = torch.empty_like(x2)
    if m and n:
        with torch.cuda.device(x2.device):
            rc = _kernel_fn()(
                x2.data_ptr(), gate.data_ptr(), beta.data_ptr(),
                out.data_ptr(), m, n, int(bool(signed)),
                int(x2.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fake_quant launch failed: CUDA error {rc}")
        fake_quant.launches += 1
    return out


fake_quant.launches = 0
