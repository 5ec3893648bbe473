"""Wrapper of the K7 CUDA kernel ``csrc/flash_attention.cu``.

Whole-prompt causal attention with an online softmax, optionally under a
sliding ``window`` with ``sinks`` (DESIGN.md §17) and a ``softcap``: the
card's counterpart of
``repro/kernels/flash_attention/flash_attention.py:flash_attention_pallas``.
The source's header says what bounds it and how the kernel is laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)


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
    tensor launches the kernel on the current stream, without
    synchronising, adds one to ``flash_attention.launches`` and raises if
    the launch is refused.
    """
    _check(q, k, v, window, sinks)
    if not _on_card(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, sinks=sinks)
    b, hq, s, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must all be bf16 or all fp32, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous last axis")
    out = torch.empty((b, s, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b and hq and s:
        with torch.cuda.device(q.device):
            rc = _kernel_fn()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], b, hq, k.shape[1], s, d,
                int(q.dtype == torch.bfloat16), int(causal),
                0 if window is None else int(window), int(sinks),
                d ** -0.5, 0.0 if softcap is None else float(softcap),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention launch failed: CUDA error "
                               f"{rc}")
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
