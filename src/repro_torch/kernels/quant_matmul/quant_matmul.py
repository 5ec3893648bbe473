"""Wrappers of the K1, K4, K5 and K6 CUDA kernels ``csrc/quant_matmul.cu``.

``y = scale * (x @ codes) + bias * rowsum(x)``, which equals
``x @ (codes * scale + bias)``. ``quant_matmul`` (K1, int8 codes) is the
card's counterpart of ``repro/kernels/quant_matmul/quant_matmul.py:
quant_matmul_pallas``; ``quant_matmul_packed`` (K4, 2/4-bit codes packed
along K by ``quant/pack.py``) that of ``quant_matmul_packed_pallas``.

``y = eff_scale * (qx @ codes) + eff_bias * rowsum(qx) + const`` with the
product of int8 activation and weight codes summed in int32:
``int_matmul`` (K5, int8 codes) is the counterpart of
``int_matmul_pallas``, ``int_matmul_packed`` (K6) of
``int_matmul_packed_pallas``. Each also takes fp32 activations with their
per-tensor grid (``act``) and quantizes them in the kernel, as the serving
path does. The source's header says what bounds the kernels and how they
are laid out. K5 is K6's 8-bit case: both take ``kernel_path``'s two paths
through one C entry: at M <= ``DECODE_M`` a split-K stream over
``int_split_plan``'s chunks in one launch (the splits add their exact sums,
split into a high and a low part, into a workspace of the device and
stream that the last block of each column tile reads and zeroes), above it
int8 ``wgmma`` tiles.

K1 and K4 take x in bf16 (the serving path's activations) or fp32 and run
one of two paths, picked from (M, N, K) alone and the same for both
(``kernel_path``): at M <= ``DECODE_M`` a split-K stream of the codes over
``split_plan``'s chunks, with a second launch that adds the splits'
partials in split order; above it bf16 ``wgmma`` tiles with the codes
widened to bf16 in shared memory (fp32 x as two bf16 terms). Either way
one call counts one launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.kernels import _build

from repro_torch.quant.pack import packed_rows

from .ref import (int_matmul_packed_ref, int_matmul_ref,
                  quant_matmul_packed_ref, quant_matmul_ref,
                  quantize_act_ref)


# M at or below which K1/K4 stream the codes (decode: the serving slots);
# above it they run the wgmma tiles (prefill)
DECODE_M = 8
# the stream's blocks: 128 columns, 16 K slices of whole groups of 4 K rows
# (one packed row at 2 bits, two at 4); a launch aims at 2 blocks an SM of
# an H100 (132 SMs), each split at least a quarter of a block's slices deep
_STREAM_COLS, _STREAM_SLICES, _GROUP = 128, 16, 4
_STREAM_BLOCKS = 2 * 132
_MIN_CHUNK_GROUPS = _STREAM_SLICES // 4
# a block stages its chunk's x in shared memory: at most 4096 K rows
_MAX_CHUNK_GROUPS = 1024
_MAX_SPLITS = 65535
_PATHS = {"stream": 0, "wgmma": 1}


def kernel_path(m: int, n: int, k: int) -> str:
    """The path K1, K4, K5 and K6 take at (M, N, K): ``"stream"`` (decode,
    M <= ``DECODE_M``, or K = 0) or ``"wgmma"`` (prefill). Never depends on
    bits or dtype."""
    return "stream" if m <= DECODE_M or k == 0 else "wgmma"


@functools.lru_cache(maxsize=4096)
def split_plan(n: int, k: int) -> tuple[int, int]:
    """(splits, chunk) of the stream path over N columns and K rows:
    ``chunk`` K rows a split, a whole number of groups of 4 (so of packed
    rows at 2 and 4 bits) and of 8 (whole 16-byte loads of bf16 x),
    ``splits = ceil(K / chunk)``; as many splits as keep ceil(N / 128) x
    splits within one wave of ~2 blocks an SM, none shallower than 4
    groups nor deeper than 1024 (4096 K rows of x staged in shared
    memory). From (N, K) alone: K1 and K4 at every bits sum in one
    order."""
    groups = max(1, -(-k // _GROUP))
    n_tiles = -(-n // _STREAM_COLS)
    want = max(1, _STREAM_BLOCKS // max(1, n_tiles))
    chunk_groups = min(_MAX_CHUNK_GROUPS,
                       max(_MIN_CHUNK_GROUPS, -(-groups // want)))
    chunk_groups += chunk_groups % 2   # 8 K rows: whole 16-byte x loads
    return -(-groups // chunk_groups), chunk_groups * _GROUP


# K5's and K6's stream: the same blocks and groups, each split at least 16
# groups deep (its atomics cost ~M x 32 a block, so fewer, deeper splits
# than K1/K4's). A split's int32 sums enter the workspace as fp32 integers
# hi = v >> 12 and lo = v & 4095, which fp32 adds exactly (below 2^24) in
# any order while splits x 4095 < 2^24: at most 4096 splits. The workspace
# keeps 8 rows of sums a column tile in each of the two planes
_INT_MIN_CHUNK_GROUPS = 16
_INT_MAX_SPLITS = 4096
_WS_ROWS = 8


@functools.lru_cache(maxsize=4096)
def int_split_plan(n: int, k: int) -> tuple[int, int]:
    """(splits, chunk) of K5's and K6's stream over N columns and K rows:
    ``chunk`` K rows a split, a whole number of groups of 4 (so of packed
    rows at 2 and 4 bits), ``splits = ceil(K / chunk)``; as many splits as
    keep ceil(N / 128) x splits within one wave of ~2 blocks an SM, none
    shallower than 16 groups, never more than 4096 (the exact hi/lo
    combine). From (N, K) alone, the same at every bits."""
    groups = max(1, -(-k // _GROUP))
    n_tiles = -(-n // _STREAM_COLS)
    want = max(1, _STREAM_BLOCKS // max(1, n_tiles))
    chunk_groups = max(_INT_MIN_CHUNK_GROUPS, -(-groups // want),
                       -(-groups // _INT_MAX_SPLITS))
    return -(-groups // chunk_groups), chunk_groups * _GROUP


def int_stream_ws_bytes(n: int) -> int:
    """Bytes of K5's and K6's stream workspace over N columns, as
    ``csrc/quant_matmul.cu:istream::ws_bytes_for`` lays it out: the hi and
    the lo plane of fp32 sums (8 x 128 a tile each), int32 row sums (8 a
    tile) and arrival counters for each of the ceil(N / 128) column
    tiles."""
    tiles = -(-n // _STREAM_COLS)
    return 4 * tiles * (1 + _WS_ROWS + 2 * _WS_ROWS * _STREAM_COLS)


# K5's and K6's stream workspaces, one a (device, stream), zero between
# calls: a launch's last block of each column tile zeroes what the tile's
# splits added. Two streams never share one, and a buffer that is outgrown
# stays in _INT_WS_KEPT, since a CUDA graph that captured a call holds its
# address
_INT_WS: dict[tuple, torch.Tensor] = {}
_INT_WS_KEPT: list[torch.Tensor] = []


def _int_stream_ws(device, stream: int, nbytes: int) -> torch.Tensor:
    """The K5/K6 stream workspace of ``device`` and the raw ``stream``, made
    (zeroed) or grown (zeroed, doubled) where it holds fewer than
    ``nbytes``. During
    a graph capture the zeroing is captured with it and the buffer comes
    from the graph's pool. Graphs captured on one stream share its buffer,
    so they must not be replayed at once on two streams."""
    key = (device, stream)
    ws = _INT_WS.get(key)
    if ws is None or ws.numel() < nbytes:
        if ws is not None:
            _INT_WS_KEPT.append(ws)
        old = 0 if ws is None else ws.numel()
        ws = torch.zeros((max(nbytes, 2 * old),), dtype=torch.uint8,
                         device=device)
        _INT_WS[key] = ws
    return ws


def _int_tile_prep(x, codes, m: int, n: int, k: int, quant: bool):
    """(x_prep, codes_prep, workspace bytes) of K5's and K6's wgmma path, as
    ``csrc/quant_matmul.cu:itile::launch`` lays the workspace out: x goes
    through ``prep`` (int8 rows of a multiple of 16 bytes, with their int32
    row sums) when it is fp32 or its int8 rows are not 16-byte aligned;
    codes (int8 or packed) through ``pad_codes`` unless their rows are
    16-byte aligned."""
    x_prep = quant or k % 16 != 0 or x.data_ptr() % 16 != 0
    codes_prep = n % 16 != 0 or codes.data_ptr() % 16 != 0
    nbytes = 0
    if x_prep:
        nbytes += _round_up(m * _round_up(k, 16), 256) \
            + _round_up(4 * m, 256)
    if codes_prep:
        nbytes += codes.shape[0] * _round_up(n, 16)
    return x_prep, codes_prep, nbytes


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def _tile_prep(x, codes, m: int, n: int, k: int):
    """(x_prep, codes_prep, workspace bytes) of the wgmma path, as
    ``csrc/quant_matmul.cu:tile::launch`` lays the workspace out: x goes
    through ``prep_x`` unless it is bf16 with 16-byte aligned rows (fp32 x
    as two bf16 terms), codes through ``pad_codes`` unless their rows are
    16-byte aligned."""
    rows = codes.shape[0]
    x_prep = x.dtype != torch.bfloat16 or k % 8 != 0 \
        or x.data_ptr() % 16 != 0
    codes_prep = n % 16 != 0 or codes.data_ptr() % 16 != 0
    nbytes = 0
    if x_prep:
        terms = 1 if x.dtype == torch.bfloat16 else 2
        nbytes += terms * _round_up(m * _round_up(k, 8) * 2, 256)
    if codes_prep:
        nbytes += rows * _round_up(n, 16)
    return x_prep, codes_prep, nbytes


@functools.lru_cache(maxsize=None)
def _fused_fn():
    fn = _build.load("quant_matmul").quant_matmul_fused
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int] + [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _current(dev: int):
    """A context that makes ``dev`` current only when it is not; the
    current stream's raw handle is read without building a Stream."""
    return contextlib.nullcontext() if dev == torch.cuda.current_device() \
        else torch.cuda.device(dev)


def _fused_launch(wrapper, x, codes, scale, bias, rowsum, *, bits: int,
                  k: int) -> torch.Tensor:
    """Check, launch K1 (``bits`` 8) or K4 on the current stream without
    synchronising, count one launch and note its path (``wrapper.path``,
    ``kernel_path``'s tag); raise if it was refused."""
    _check(x, codes, scale, bias, rowsum, bits=bits)
    m, n = x.shape[0], codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if not (m and n):
        return out
    path = kernel_path(m, n, k)
    splits, chunk, x_prep, codes_prep = 1, 0, False, False
    if path == "stream":
        splits, chunk = split_plan(n, k)
        if splits > _MAX_SPLITS:
            raise ValueError(f"{splits} splits of K = {k} exceed the grid")
        nbytes = 4 * splits * m * n if splits > 1 else 0
    else:
        x_prep, codes_prep, nbytes = _tile_prep(x, codes, m, n, k)
    # freed when this returns: the caching allocator hands it out again
    # only to work that the stream runs after this call's launches
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=x.device) \
        if nbytes else None
    dev = x.get_device()
    with _current(dev):
        rc = _fused_fn()(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            bits, scale.data_ptr(), bias.data_ptr(), rowsum.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), nbytes,
            m, n, k, _PATHS[path], splits, chunk, int(x_prep),
            int(codes_prep), torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{rc}")
    wrapper.launches += 1
    wrapper.path = path
    return out


@functools.lru_cache(maxsize=None)
def _int_fn():
    fn = _build.load("quant_matmul").int_matmul_fused
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the activations K1 and K4 read
X_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, codes, scale, bias, rowsum, *, bits: int = 8):
    """Device, dtype, shape and contiguity of the operands. x: fp32 or
    bf16 (``X_DTYPES``); ``bits`` 8: int8 codes (K, N); 2 or 4: uint8 codes
    (ceil(K/per), N)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if x.dtype not in X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    m, k = x.shape
    rows = k if bits == 8 else packed_rows(k, bits)
    if codes.ndim != 2 or codes.shape[0] != rows:
        raise ValueError(f"codes {tuple(codes.shape)} do not match x "
                         f"{tuple(x.shape)} at {bits} bits")
    n = codes.shape[1]
    code_dtype = torch.int8 if bits == 8 else torch.uint8
    want = ((x, x.dtype, (m, k)), (codes, code_dtype, (rows, n)),
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
    """x: (M, K) fp32 or bf16; codes: (K, N) int8; scale/bias: (N,) fp32;
    rowsum: (M,) fp32 ``sum_k x[m, k]``. Returns (M, N) fp32.

    A CPU tensor takes the plain version (``quant_matmul_ref``); a CUDA
    tensor launches the kernel on the current stream, without
    synchronising, and raises if the launch is refused.
    """
    if x.device.type == "cpu":
        return quant_matmul_ref(x, codes, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cpu or cuda, not {x.device}")
    return _fused_launch(quant_matmul, x, codes, scale, bias, rowsum,
                         bits=8, k=x.shape[-1])


quant_matmul.launches = 0
quant_matmul.path = None


def quant_matmul_packed(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        rowsum: torch.Tensor, *, bits: int,
                        k: int) -> torch.Tensor:
    """x: (M, K) fp32 or bf16; packed: (ceil(K/per), N) uint8 ``bits``-bit
    codes (``quant/pack.py`` layout); scale/bias: (N,) fp32; rowsum: (M,)
    fp32; ``k`` the logical fan-in (x's K). Returns (M, N) fp32.

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
    return _fused_launch(quant_matmul_packed, x, packed, scale, bias, rowsum,
                         bits=bits, k=k)


quant_matmul_packed.launches = 0
quant_matmul_packed.path = None


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
    synchronising, count one launch and note its path (``wrapper.path``,
    ``kernel_path``'s tag); raise if it was refused."""
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda, not "
                         f"{x.device}")
    _check_int(x, codes, eff_scale, eff_bias, rowsum, const, act, bits=bits,
               k=k)
    m, n = x.shape[0], codes.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if not (m and n):
        return out
    grid, act_bits = act if act is not None else (None, 0)
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    path = kernel_path(m, n, k)
    splits, chunk, x_prep, codes_prep = 1, 0, False, False
    if path == "stream":
        splits, chunk = int_split_plan(n, k)
        nbytes = int_stream_ws_bytes(n) if splits > 1 else 0
        ws = _int_stream_ws(dev, stream, nbytes) if nbytes else None
    else:
        x_prep, codes_prep, nbytes = _int_tile_prep(x, codes, m, n, k,
                                                    act is not None)
        # freed when this returns: the caching allocator hands it out again
        # only to work that the stream runs after this launch
        ws = torch.empty((nbytes,), dtype=torch.uint8, device=x.device) \
            if nbytes else None
    with _current(dev):
        rc = _int_fn()(
            x.data_ptr(), int(act is not None), codes.data_ptr(),
            eff_scale.data_ptr(), eff_bias.data_ptr(),
            None if rowsum is None else rowsum.data_ptr(),
            const.data_ptr(), None if grid is None else grid.data_ptr(),
            act_bits, out.data_ptr(), m, n, k, bits, _PATHS[path], splits,
            chunk, None if ws is None else ws.data_ptr(),
            0 if ws is None else ws.numel(), int(x_prep), int(codes_prep),
            stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA "
                           f"error {rc}")
    wrapper.launches += 1
    wrapper.path = path
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
int_matmul.path = None


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
int_matmul_packed.path = None
