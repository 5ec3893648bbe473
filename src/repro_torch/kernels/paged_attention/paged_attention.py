"""Wrappers of the K2a, K2b and K2c CUDA kernels ``csrc/paged_attention.cu``.

One-token GQA decode over a paged KV pool: the card's counterpart of
``repro/kernels/paged_attention/paged_attention.py:paged_attention_pallas``
over a float pool (K2a) or a quantized one with ``k_scale``/``v_scale``
(K2b: int8 codes or int4 nibbles plus fp16 group scales, ``quant/kv.py``),
and, under a sliding ``window`` with ``sinks`` (DESIGN.md §17), over either
pool (K2c: ``paged_attention_window``, ``paged_attention_quant_window``,
each counting its own launches). Each call launches a split pass over
chunks of the rows' live blocks and a combine pass that merges them in
split order (``split_plan``); it counts as one launch. The source's
header says what bounds them and how the kernels are laid out.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build

from .ref import paged_attention_ref

# cached tokens a split thread block walks (rounded down to whole blocks):
# a gemma2 row of ~4500 tokens is ~70 chunks, several hundred thread blocks
# a launch; a tinyllama row of <= 512 tokens at most 8
CHUNK_TOKENS = 64
# the kernel's limits: head elements a lane owns (head_dim is a multiple of
# it, up to 256), blocks in a chunk, splits (the combine keeps a weight of
# each in shared memory), a grid axis, tokens in a chunk
_LANE_ELEMS, _MAX_CHUNK, _MAX_SPLITS, _MAX_GRID = 8, 64, 4096, 65535
_MAX_CHUNK_TOKENS = 2048
_HEAD_TILE = 8          # query heads a split thread block scores
_ALIGN = {torch.int8: 8, torch.uint8: 4}


@functools.lru_cache(maxsize=1024)
def split_plan(block_size: int, max_blocks: int, window: int | None = None,
               sinks: int = 0) -> tuple[int, int]:
    """(chunk, n_splits) of a call, from integers the host holds (never
    from ``pos``, which lives on the device): ``chunk`` blocks per split,
    from CHUNK_TOKENS and the block size alone, so that a window changes
    no chunk; ``n_splits`` = ceil(S / chunk), S the most live blocks a row
    can have: the table width, or under a window min(max_blocks,
    ceil(sinks / bs) + ceil(window / bs) + 1) (the sink blocks, then the
    blocks a window of ``window`` tokens can touch)."""
    chunk = max(1, min(_MAX_CHUNK, CHUNK_TOKENS // block_size))
    live = max_blocks
    if window is not None:
        live = min(max_blocks, -(-sinks // block_size)
                   + -(-window // block_size) + 1)
    return chunk, max(1, -(-live // chunk))


@functools.lru_cache(maxsize=None)
def _kernel_fn(windowed: bool = False):
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_window_bf16q if windowed \
        else lib.paged_attention_bf16q
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * (2 * windowed) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _quant_kernel_fn(windowed: bool = False):
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_quant_window_bf16q if windowed \
        else lib.paged_attention_quant_bf16q
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * (2 * windowed) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_window(window, sinks) -> tuple[int, int]:
    if window is None or int(window) < 1 or int(sinks) < 0:
        raise ValueError(f"K2c needs window >= 1 and sinks >= 0, got "
                         f"window={window} sinks={sinks}")
    return int(window), int(sinks)


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
    if k_scale.ndim != 4 or k_scale.shape[:3] != (nb, bs, kvh) \
            or v_scale.shape != k_scale.shape:
        raise ValueError(f"scales {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)} do not page with codes "
                         f"{tuple(k_pool.shape)}")
    if k_scale.dtype != torch.float16 or v_scale.dtype != torch.float16:
        raise ValueError(f"scales must be fp16, got {k_scale.dtype}/"
                         f"{v_scale.dtype}")
    ng = k_scale.shape[-1]
    group_size = hd // ng
    if ng * group_size != hd or group_size % _LANE_ELEMS:
        raise ValueError(f"{ng} scale groups of head_dim {hd}: the kernel "
                         f"needs groups of a multiple of {_LANE_ELEMS} "
                         f"elements that divide it")
    dev = q.get_device()
    for t in (k_scale, v_scale):
        if t.get_device() != dev:
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
    if k_pool.shape != (nb, bs, kvh, last) \
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
    if pos.dtype != torch.int32 or pos.shape != (b,):
        raise ValueError(f"pos must be int32 (B,), got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    dev = q.get_device()
    for t in (k_pool, v_pool, block_table, pos):
        if t.get_device() != dev:
            raise ValueError(f"operands on {t.device} and {q.device}")
    for t in (q, k_pool, v_pool, block_table, pos):
        if not t.is_contiguous():
            raise ValueError("paged_attention operands must be contiguous")
    if hd % _LANE_ELEMS or not 0 < hd <= 256:
        raise ValueError(f"head_dim {hd}: the kernel takes multiples of "
                         f"{_LANE_ELEMS} up to 256")
    # a lane loads 16 bytes of q and of a float pool, 8 of int8 codes and
    # 4 of int4 nibbles
    for t in (q, k_pool, v_pool):
        if t.data_ptr() % _ALIGN.get(t.dtype, 16):
            raise ValueError("paged_attention operands must be 16-byte "
                             "aligned (int8 codes 8, int4 nibbles 4)")
    if kvh * -(-g // _HEAD_TILE) > _MAX_GRID or kvh * g > _MAX_GRID:
        raise ValueError(f"{kvh} KV heads x {g} query heads exceed the "
                         f"grid")
    # a chunk's tokens are resolved in shared memory to int32 pool tokens
    if bs > _MAX_CHUNK_TOKENS or nb * bs >= 2 ** 31:
        raise ValueError(f"{nb} blocks of {bs} tokens: the kernel takes "
                         f"blocks of up to {_MAX_CHUNK_TOKENS} tokens and "
                         f"fewer than 2**31 pool tokens")


def _launch(wrapper, fn, q, pools, block_table, pos, bs, ints, softcap,
            window):
    """Allocate the output and the split workspace, launch ``fn`` (the
    split and the combine pass) on the current stream over the ``pools``
    pointers and the ``ints`` after the split plan, and add one to
    ``wrapper.launches``; returns the output."""
    b, kvh, g, hd = q.shape
    mb = block_table.shape[1]
    chunk, n_splits = split_plan(bs, mb, *(window or (None,)))
    if n_splits > _MAX_SPLITS:
        raise ValueError(f"{n_splits} splits of {chunk} blocks exceed the "
                         f"kernel's {_MAX_SPLITS}")
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if not (b and kvh and g):
        return out
    # each split's partial (m, l, acc[G][hd]) in fp32. Freed when this
    # returns: the caching allocator hands it out again only to work that
    # the stream runs after the combine pass
    ws = torch.empty((b * kvh * n_splits * g * (hd + 2),),
                     dtype=torch.float32, device=q.device)
    # the launch needs q's device current and the current stream's handle:
    # the device is switched only when it differs, and the raw handle is
    # read as K7's wrapper reads it (no torch.cuda.Stream is built)
    dev = q.get_device()
    with contextlib.nullcontext() if dev == torch.cuda.current_device() \
            else torch.cuda.device(dev):
        rc = fn(q.data_ptr(), *pools, block_table.data_ptr(),
                pos.data_ptr(), out.data_ptr(), ws.data_ptr(), b, kvh, g,
                hd, bs, mb, chunk, n_splits, *ints, hd ** -0.5,
                0.0 if softcap is None else float(softcap), *(window or ()),
                torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    wrapper.launches += 1
    return out


def _launch_float(wrapper, q, k_pool, v_pool, block_table, pos, softcap,
                  window):
    """K2a (``window`` None) or K2c (``window`` = (w, sinks)) over a float
    pool."""
    _check(q, k_pool, v_pool, block_table, pos)
    return _launch(wrapper, _kernel_fn(window is not None), q,
                   (k_pool.data_ptr(), v_pool.data_ptr()), block_table, pos,
                   k_pool.shape[1], (int(k_pool.dtype == torch.bfloat16),),
                   softcap, window)


def _launch_quant(wrapper, q, k_pool, v_pool, k_scale, v_scale,
                  block_table, pos, softcap, window):
    """K2b (``window`` None) or K2c (``window`` = (w, sinks)) over a
    quantized pool."""
    _check(q, k_pool, v_pool, block_table, pos, quantized=True)
    bits, group_size = _check_scales(q, k_pool, v_pool, k_scale, v_scale)
    return _launch(wrapper, _quant_kernel_fn(window is not None), q,
                   (k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
                    v_scale.data_ptr()), block_table, pos, k_pool.shape[1],
                   (bits, group_size), softcap, window)


def _on_card(q, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.is_cuda:
        return True
    if q.device.type != "cpu":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return False


def paged_attention(q, k_pool, v_pool, block_table, pos, *,
                    softcap: float | None = None) -> torch.Tensor:
    """K2a. q: (B, KV, G, hd) bf16; pools: (num_blocks, bs, KV, hd) bf16 or
    fp32; block_table: (B, max_blocks) int32 (-1 = unallocated); pos: (B,)
    int32. Returns (B, KV, G, hd) fp32.

    A CPU tensor takes the plain version (``paged_attention_ref``); a CUDA
    tensor launches the kernel on the current stream, without
    synchronising, and raises if the launch is refused.
    """
    if not _on_card(q, "paged_attention"):
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   softcap=softcap)
    return _launch_float(paged_attention, q, k_pool, v_pool, block_table,
                         pos, softcap, None)


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
    if not _on_card(q, "paged_attention_quant"):
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   softcap=softcap, k_scale=k_scale,
                                   v_scale=v_scale)
    return _launch_quant(paged_attention_quant, q, k_pool, v_pool, k_scale,
                         v_scale, block_table, pos, softcap, None)


paged_attention_quant.launches = 0


def paged_attention_window(q, k_pool, v_pool, block_table, pos, *,
                           window: int, sinks: int = 0,
                           softcap: float | None = None) -> torch.Tensor:
    """K2c over a float pool: ``paged_attention`` attending only key
    positions ``kp <= pos`` with ``pos - kp < window or kp < sinks``
    (``sinks`` in tokens). Table entries the window has evicted (-1) are
    never read. Returns (B, KV, G, hd) fp32.

    A CPU tensor takes the plain version (``paged_attention_ref`` with the
    window); a CUDA tensor launches the kernel on the current stream,
    without synchronising, and raises if the launch is refused.
    """
    win = _check_window(window, sinks)
    if not _on_card(q, "paged_attention_window"):
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   window=win[0], sinks=win[1],
                                   softcap=softcap)
    return _launch_float(paged_attention_window, q, k_pool, v_pool,
                         block_table, pos, softcap, win)


paged_attention_window.launches = 0


def paged_attention_quant_window(q, k_pool, v_pool, k_scale, v_scale,
                                 block_table, pos, *, window: int,
                                 sinks: int = 0,
                                 softcap: float | None = None
                                 ) -> torch.Tensor:
    """K2c over a quantized pool: ``paged_attention_quant`` under the
    window and sinks of ``paged_attention_window``. Returns (B, KV, G, hd)
    fp32; a CPU tensor takes the plain version."""
    win = _check_window(window, sinks)
    if not _on_card(q, "paged_attention_quant_window"):
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   window=win[0], sinks=win[1],
                                   softcap=softcap, k_scale=k_scale,
                                   v_scale=v_scale)
    return _launch_quant(paged_attention_quant_window, q, k_pool, v_pool,
                         k_scale, v_scale, block_table, pos, softcap, win)


paged_attention_quant_window.launches = 0
