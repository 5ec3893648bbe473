"""Wrapper of the K7 CUDA kernels ``csrc/flash_attention.cu``.

Whole-prompt causal attention with an online softmax, optionally under a
sliding ``window`` with ``sinks`` (DESIGN.md §17) and a ``softcap``: the
card's counterpart of
``repro/kernels/flash_attention/flash_attention.py:flash_attention_pallas``.
Two kernels compute it; ``kernel_for`` picks one by dtype and head dim.
The source's header says what bounds them and how each is laid out.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
# head dims whose bf16 calls take the tensor-core kernel
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The K7 kernel a CUDA call launches: ``"tensor-core"`` (bf16 wgmma
    tiles fed by TMA, probabilities split into two bf16 terms) for bf16 at
    head_dim 64, 128 or 256; ``"fma"`` (fp32 CUDA-core tiles) for fp32, whose
    1e-4 tolerance a bf16 tensor-core product cannot hold, and for bf16 at
    head_dim 16 and 32, narrower than the tensor-core kernel's 64-column
    TMA box."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor-core"
    return "fma"


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 \
        + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, sinks):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: expected (B, Hq, S, D) and two "
                         f"(B, Hkv, S, D)")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (Hq % Hkv must be 0)")
    if window is not None and int(window) < 1 or int(sinks) < 0:
        raise ValueError(f"window must be None or >= 1 and sinks >= 0, got "
                         f"window={window} sinks={sinks}")


def _tma_strides(t) -> tuple[int, int, int]:
    """(batch, head, position) strides of a (B, H, S, D) bf16 operand of the
    tensor-core kernel, whose tensor maps need a 16-byte aligned base and
    positive strides that are multiples of 16 bytes (8 elements). The stride
    of a dimension of size 1 is never stepped: it is given the packed
    layout's. Raises ValueError otherwise."""
    b, h, s, d = t.shape
    sb, sh, ss, _ = t.stride()
    if b == 1:
        sb = s * h * d
    if h == 1:
        sh = d
    if s == 1:
        ss = h * d
    if t.data_ptr() % 16 or min(sb, sh, ss) <= 0 or sb % 8 or sh % 8 \
            or ss % 8:
        raise ValueError(
            f"the tensor-core flash_attention needs a 16-byte aligned base "
            f"and (batch, head, position) strides that are positive "
            f"multiples of 8 elements, got {t.data_ptr() % 16} bytes off "
            f"and strides {tuple(t.stride()[:3])}")
    return sb, sh, ss


def _on_card(q) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return True


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    sinks: int = 0) -> torch.Tensor:
    """K7. q: (B, Hq, S, D); k/v: (B, Hkv, S, D), Hq % Hkv == 0, all bf16 or
    all fp32, any strides with a contiguous last axis (the model's (B, S,
    H, D) tensors transposed). Returns (B, Hq, S, D) in q's dtype, laid out
    as a (B, S, Hq, D) tensor transposed, so the model's reshape back is
    free.

    A CPU tensor takes the plain version (``flash_attention_ref``); a CUDA
    tensor launches a kernel on the current stream, without synchronising,
    adds one to ``flash_attention.launches`` and raises if the launch is
    refused. Which kernel, by dtype and head dim (``kernel_for``): bf16 at
    head_dim 64, 128 or 256 takes the tensor-core kernel, whose operands
    need a 16-byte aligned base and (batch, head, position) strides that
    are multiples of 8 elements (else ValueError); fp32, and bf16 at 16 or
    32, take the fp32 FMA kernel.
    """
    _check(q, k, v, window, sinks)
    if not _on_card(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, sinks=sinks)
    b, hq, s, d = q.shape
    dtype = q.dtype
    if dtype not in (torch.bfloat16, torch.float32) or k.dtype != dtype \
            or v.dtype != dtype:
        raise ValueError(f"q/k/v must all be bf16 or all fp32, got "
                         f"{dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"operands on {k.device}/{v.device} and {q.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs a contiguous last axis")
    # the C entry makes the same choice from dtype and head_dim; the
    # tensor-core kernel's TMA maps need the alignment checked here
    if kernel_for(dtype, d) == "tensor-core":
        strides = _tma_strides(q) + _tma_strides(k) + _tma_strides(v)
    else:
        strides = q.stride()[:3] + k.stride()[:3] + v.stride()[:3]
    # (B, S, Hq, D) memory seen as (B, Hq, S, D), allocated in one call
    o_strides = (s * hq * d, d, hq * d)
    out = torch.empty_strided((b, hq, s, d), o_strides + (1,), dtype=dtype,
                              device=q.device)
    if b and hq and s:
        # the launch needs q's device current and the current stream's
        # handle. Entering a device guard and building a torch.cuda.Stream
        # cost host time that a kernel at tinyllama's prefill shape does
        # not hide: the device is switched only when it differs, and the
        # raw handle is read as Triton's launchers read it
        dev = q.get_device()
        with contextlib.nullcontext() if dev == torch.cuda.current_device() \
                else torch.cuda.device(dev):
            rc = _kernel_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *strides, *o_strides, b, hq, k.shape[1], s, d,
                int(dtype == torch.bfloat16), int(causal),
                0 if window is None else int(window), int(sinks),
                d ** -0.5, 0.0 if softcap is None else float(softcap),
                torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            raise RuntimeError(f"flash_attention launch failed: CUDA error "
                               f"{rc}")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
