"""Wrapper of the K2a CUDA kernel ``csrc/paged_attention.cu``.

One-token GQA decode over a paged float KV pool: the card's counterpart of
``repro/kernels/paged_attention/paged_attention.py:paged_attention_pallas``
with a float pool and no window. The source's header says what bounds it
and how the kernel is laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import paged_attention_ref

# shared memory the kernel stages per block: K and V of one block, as fp32
_SMEM_LIMIT = 48 * 1024


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("paged_attention").paged_attention_bf16q
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, block_table, pos):
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)} / pool {tuple(k_pool.shape)}: "
                         f"expected (B, KV, G, hd) / (num_blocks, bs, KV, hd)")
    b, kvh, g, hd = q.shape
    nb, bs = k_pool.shape[:2]
    if tuple(k_pool.shape) != (nb, bs, kvh, hd) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
                         f" do not match q {tuple(q.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16, got {q.dtype}")
    if k_pool.dtype not in (torch.bfloat16, torch.float32) \
            or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pools must both be bf16 or fp32, got "
                         f"{k_pool.dtype}/{v_pool.dtype}")
    if block_table.dtype != torch.int32 or block_table.ndim != 2 \
            or block_table.shape[0] != b:
        raise ValueError(f"block_table must be int32 (B, max_blocks), got "
                         f"{block_table.dtype} {tuple(block_table.shape)}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be int32 (B,), got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    for t in (k_pool, v_pool, block_table, pos):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    for t in (q, k_pool, v_pool, block_table, pos):
        if not t.is_contiguous():
            raise ValueError("paged_attention operands must be contiguous")
    if hd > 256 or g > 32:
        raise ValueError(f"head_dim {hd} > 256 or group {g} > 32 warps")
    if 2 * bs * hd * 4 > _SMEM_LIMIT:
        raise ValueError(f"block {bs} x head_dim {hd} exceeds the kernel's "
                         f"shared-memory staging")


def paged_attention(q, k_pool, v_pool, block_table, pos, *,
                    softcap: float | None = None) -> torch.Tensor:
    """q: (B, KV, G, hd) bf16; pools: (num_blocks, bs, KV, hd) bf16 or fp32;
    block_table: (B, max_blocks) int32 (-1 = unallocated); pos: (B,) int32.
    Returns (B, KV, G, hd) fp32.

    A CPU tensor takes the plain version (``paged_attention_ref``); a CUDA
    tensor launches the kernel on the current stream, without
    synchronising, and raises if the launch is refused.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k_pool, v_pool, block_table, pos)
    b, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if b and kvh:
        with torch.cuda.device(q.device):
            rc = _kernel_fn()(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                b, kvh, g, hd, bs, block_table.shape[1],
                int(k_pool.dtype == torch.bfloat16), hd ** -0.5,
                0.0 if softcap is None else float(softcap),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"paged_attention launch failed: CUDA error "
                               f"{rc}")
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
