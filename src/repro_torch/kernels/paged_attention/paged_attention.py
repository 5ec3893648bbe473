"""Wrapper of the K2a and K2b CUDA kernels ``csrc/paged_attention.cu``.

One-token GQA decode over a paged KV pool: the card's counterpart of
``repro/kernels/paged_attention/paged_attention.py:paged_attention_pallas``
with no window, over a float pool (K2a) or a quantized one with
``k_scale``/``v_scale`` (K2b: int8 codes or int4 nibbles plus fp16 group
scales, ``quant/kv.py``). The source's header says what bounds them and how
the kernels are laid out.
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


@functools.lru_cache(maxsize=None)
def _quant_kernel_fn():
    fn = _build.load("paged_attention").paged_attention_quant_bf16q
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_scales(q, k_pool, v_pool, k_scale, v_scale) -> tuple[int, int]:
    """A quantized pool's codes and scales; returns (bits, group_size)."""
    hd = q.shape[-1]
    nb, bs, kvh = k_pool.shape[:3]
    if k_pool.dtype == torch.int8:
        bits, hdp = 8, hd
    elif k_pool.dtype == torch.uint8:
        bits, hdp = 4, -(-hd // 2)
    else:
        raise ValueError(f"quantized pools hold int8 codes or uint8 int4 "
                         f"nibbles, got {k_pool.dtype}")
    if v_pool.dtype != k_pool.dtype or k_pool.shape[-1] != hdp \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"code pools {k_pool.dtype} {tuple(k_pool.shape)} / "
                         f"{v_pool.dtype} {tuple(v_pool.shape)} do not hold "
                         f"{bits}-bit codes of head_dim {hd}")
    if k_scale.ndim != 4 or tuple(k_scale.shape[:3]) != (nb, bs, kvh) \
            or v_scale.shape != k_scale.shape:
        raise ValueError(f"scales {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)} do not page with codes "
                         f"{tuple(k_pool.shape)}")
    if k_scale.dtype != torch.float16 or v_scale.dtype != torch.float16:
        raise ValueError(f"scales must be fp16, got {k_scale.dtype}/"
                         f"{v_scale.dtype}")
    ng = k_scale.shape[-1]
    group_size = hd // ng
    if ng * group_size != hd:
        raise ValueError(f"{ng} scale groups do not divide head_dim {hd}")
    for t in (k_scale, v_scale):
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention operands must be contiguous")
    return bits, group_size


def _check(q, k_pool, v_pool, block_table, pos, *, quantized: bool = False):
    if q.ndim != 4 or k_pool.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)} / pool {tuple(k_pool.shape)}: "
                         f"expected (B, KV, G, hd) / (num_blocks, bs, KV, hd)")
    b, kvh, g, hd = q.shape
    nb, bs = k_pool.shape[:2]
    last = k_pool.shape[-1] if quantized else hd
    if tuple(k_pool.shape) != (nb, bs, kvh, last) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}"
                         f" do not match q {tuple(q.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16, got {q.dtype}")
    if not quantized and (k_pool.dtype not in (torch.bfloat16, torch.float32)
                          or v_pool.dtype != k_pool.dtype):
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
    """K2a. q: (B, KV, G, hd) bf16; pools: (num_blocks, bs, KV, hd) bf16 or
    fp32; block_table: (B, max_blocks) int32 (-1 = unallocated); pos: (B,)
    int32. Returns (B, KV, G, hd) fp32.

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


def paged_attention_quant(q, k_pool, v_pool, k_scale, v_scale, block_table,
                          pos, *, softcap: float | None = None
                          ) -> torch.Tensor:
    """K2b. As ``paged_attention`` over a quantized pool: int8 codes
    (num_blocks, bs, KV, hd) or uint8 int4 nibbles (num_blocks, bs, KV,
    ceil(hd/2)), with ``k_scale``/``v_scale`` (num_blocks, bs, KV, ng) fp16
    group scales paged through the same table. Returns (B, KV, G, hd) fp32.

    A CPU tensor takes the plain version (``paged_attention_ref`` with the
    scales); a CUDA tensor launches the kernel on the current stream,
    without synchronising, and raises if the launch is refused.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   softcap=softcap, k_scale=k_scale,
                                   v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_quant runs on cpu or cuda, not "
                         f"{q.device}")
    _check(q, k_pool, v_pool, block_table, pos, quantized=True)
    bits, group_size = _check_scales(q, k_pool, v_pool, k_scale, v_scale)
    b, kvh, g, hd = q.shape
    bs = k_pool.shape[1]
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if b and kvh:
        with torch.cuda.device(q.device):
            rc = _quant_kernel_fn()(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(),
                block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                b, kvh, g, hd, bs, block_table.shape[1], bits, group_size,
                hd ** -0.5, 0.0 if softcap is None else float(softcap),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"paged_attention_quant launch failed: CUDA "
                               f"error {rc}")
        paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0
