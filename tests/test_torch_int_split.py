"""K6's two paths, as far as the CPU can hold them.

K6 (``int_matmul_packed``, ``csrc/quant_matmul.cu``) picks a path from
(M, N, K) alone (``kernel_path``): at M <= ``DECODE_M`` a split-K stream
over ``int_split_plan``'s chunks in one launch, whose splits add their
exact sums into a per-device workspace (``int_stream_ws_bytes``) that the
last block of each column tile reads and zeroes; above it int8 ``wgmma``
tiles, whose producer widens the packed codes into a K-major int8 tile.
Every sum is exact, so a torch model of the stream's sums (the biased
unsigned codes, the bias taken off through each split's row sums, the
splits added in any order) must give the plain version's bits and
``repro``'s op run op by op; and the byte arithmetic that widens the fields
(``widen4`` of the stream, ``widen`` of the tiles), emulated here in numpy,
must give ``unpack_codes``' codes. The workspace is kept one a device and
stream, and a buffer it outgrows stays alive for the graphs that captured
it. The kernels run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.kernels.quant_matmul.ops import \
    int_matmul_packed_op as j_int_matmul_packed_op
from repro.quant.pack import pack_codes as j_pack_codes
from repro_torch.core.quantizer import quantize_to_int
from repro_torch.kernels.quant_matmul import ops
from repro_torch.kernels.quant_matmul import quant_matmul as qmm
from repro_torch.kernels.quant_matmul.ref import (int_matmul_packed_ref,
                                                  quantize_act_ref)
from repro_torch.quant.pack import pack_codes, unpack_codes

GROUP = 4          # K rows of a stream group: one packed row at 2 bits
TILE_BK = 128      # K codes of a wgmma tile's stage


SERVING = [(2048, 2048), (5632, 2048), (32000, 2048), (256, 2048),
           (9216, 2304), (256000, 2304)]
ODD = [(37, 101), (300, 2050), (1, 64), (130, 4099), (3, 0), (64, 16385)]


@pytest.mark.parametrize("nk", SERVING + ODD)
def test_int_split_plan_covers_k_in_whole_packed_rows(nk):
    """Every K row in exactly one split, every split a whole number of
    packed rows at 2 and 4 bits; the plan is one function of (N, K)."""
    n, k = nk
    splits, chunk = qmm.int_split_plan(n, k)
    assert chunk % GROUP == 0 and chunk >= min(16 * GROUP, max(k, 1))
    assert 1 <= splits <= qmm._MAX_SPLITS
    # past K = 16384 fp32 would not add the splits' int32 sums exactly
    assert splits == 1 or k <= 16384
    assert (splits - 1) * chunk < max(k, 1) <= splits * chunk
    for bits in (2, 4):
        per = 8 // bits
        assert chunk % per == 0   # a split starts on a packed row
    assert qmm.int_split_plan.__wrapped__(n, k) == (splits, chunk)
    if (n, k) in SERVING[:4]:
        # tinyllama's K6 sites fill the card, or stream K whole (the head)
        blocks = -(-n // 128) * splits
        assert blocks >= 64 and (splits == 1) == (n >= 32000)


def test_int_paths_workspace_and_tile_preparation():
    """K6's path from (M, N, K) alone; the stream's workspace holds 8 x
    128 fp32 sums, 8 int32 row sums and an arrival counter a column tile;
    the tiles quantize fp32 x (and copy int8 rows TMA cannot take) into
    their workspace, with int32 row sums, and pad unaligned packed rows."""
    for m, n, k in [(8, 256, 2048), (1, 37, 101), (5, 3, 0)]:
        assert qmm.kernel_path(m, n, k) == "stream"
    for m, n, k in [(9, 37, 101), (352, 5632, 2048), (512, 32000, 2048)]:
        assert qmm.kernel_path(m, n, k) == "wgmma"
    for n, tiles in [(1, 1), (128, 1), (129, 2), (32000, 250)]:
        assert qmm.int_stream_ws_bytes(n) == 4 * tiles * (1 + 8 + 8 * 128)
    packed = torch.zeros((1024, 5632), dtype=torch.uint8)   # K 2048, 4 bits
    xf = torch.zeros((512, 2048), dtype=torch.float32)
    assert qmm._int_tile_prep(xf, packed, 512, 5632, 2048, True) \
        == (True, False, 512 * 2048 + 2048)
    xq = torch.zeros((512, 2048), dtype=torch.int8)
    assert qmm._int_tile_prep(xq, packed, 512, 5632, 2048, False) \
        == (False, False, 0)
    odd = torch.zeros((26, 37), dtype=torch.uint8)   # K 101 at 2 bits
    xo = torch.zeros((9, 101), dtype=torch.int8)
    # x: 9 rows of 112 bytes (1008, to 1024), row sums 36 (to 256), then
    # 26 packed rows of 48 bytes
    assert qmm._int_tile_prep(xo, odd, 9, 37, 101, False) \
        == (True, True, 1024 + 256 + 26 * 48)


def _int_inputs(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 1.5).astype(np.float32)
    half = 1 << (bits - 1)
    codes = rng.integers(-half, half, size=(k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)
    bias = rng.uniform(-1e-3, 1e-3, size=(n,)).astype(np.float32)
    colsum = codes.astype(np.int32).sum(0).astype(np.int32)
    beta = np.float32(2.0)
    return x, codes, scale, bias, colsum, beta


def stream_model(qx, packed, eff_scale, eff_bias, const, *, bits, k,
                 rowsum=None):
    """K6's stream in torch: each split of ``int_split_plan`` multiplies
    the activation codes by the biased (unsigned) codes and takes off
    2^(b-1) times its own row sums; the splits' int32 sums, and their row
    sums, are added in reverse split order (any order gives the same
    integers); then the plain version's epilogue, the row sums those of
    the fp32 loader unless ``rowsum`` is given."""
    m, n = qx.shape[0], packed.shape[1]
    splits, chunk = qmm.int_split_plan(n, k)
    half = 1 << (bits - 1)
    biased = unpack_codes(packed, bits, k).numpy().astype(np.int64) + half
    a = qx.numpy().astype(np.int64)
    acc = np.zeros((m, n), np.int64)
    rs = np.zeros((m,), np.int64)
    for s in reversed(range(splits)):
        lo, hi = s * chunk, min(k, (s + 1) * chunk)
        part_rs = a[:, lo:hi].sum(1)
        acc += a[:, lo:hi] @ biased[lo:hi] - half * part_rs[:, None]
        rs += part_rs
    assert np.abs(acc).max(initial=0) < 2**31
    r = torch.from_numpy(rs.astype(np.float32)) if rowsum is None else rowsum
    return (torch.from_numpy(acc.astype(np.int32)).to(torch.float32)
            * eff_scale[None, :] + r[:, None] * eff_bias[None, :]
            + const[None, :])


def _stream_case(mkn, bits):
    """The model's output and the plain version's on one seeded case, and
    what repro's op needs to recompute it."""
    m, k, n = mkn
    x, codes, scale, bias, colsum, beta = _int_inputs(m, k, n, bits,
                                                      seed=sum(mkn) + bits)
    tx = torch.from_numpy(x)
    qx, sx, bx = quantize_to_int(tx, 8, torch.tensor(beta), True)
    es, eb, const = ops._fold(torch.from_numpy(scale), torch.from_numpy(bias),
                              torch.from_numpy(colsum), sx, bx, k)
    grid = torch.stack([-torch.tensor(beta), torch.tensor(beta), sx])
    q2, rowsum = quantize_act_ref(tx, grid, 8)
    assert torch.equal(q2, qx)
    packed = pack_codes(torch.from_numpy(codes), bits)
    got = stream_model(qx, packed, es, eb, const, bits=bits, k=k)
    want = int_matmul_packed_ref(qx, packed, es, eb, rowsum, const,
                                 bits=bits, k=k)
    given = stream_model(qx, packed, es, eb, const, bits=bits, k=k,
                         rowsum=rowsum)
    return got, want, given, (x, codes, scale, bias, colsum, beta)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("mkn", [(3, 101, 37), (8, 2050, 300), (5, 64, 1),
                                 (1, 4099, 130)])
def test_stream_sums_bit_equal_to_plain(mkn, bits):
    """Ragged M, N and K (K no whole packed row; 1-33 splits): the model's
    bits equal the plain version's, with the fp32 loader's row sums and
    with int8 codes and their row sums given."""
    got, want, given, _ = _stream_case(mkn, bits)
    assert torch.equal(got, want) and torch.equal(given, want)


@pytest.mark.parametrize("bits", [2, 4])
def test_stream_sums_bit_equal_to_repro_op_by_op(bits):
    """5 splits over a K of no whole packed row: the model's bits equal
    repro's ``int_matmul_packed_op`` run op by op (``jax.disable_jit``: the
    same fp32 operations in the same order)."""
    mkn = (8, 259, 37)
    got, _, _, (x, codes, scale, bias, colsum, beta) = _stream_case(mkn,
                                                                    bits)
    with jax.disable_jit():
        j = j_int_matmul_packed_op(
            jnp.asarray(x), j_pack_codes(jnp.asarray(codes), bits),
            jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(colsum),
            jnp.asarray(beta), bits=bits, k=mkn[1], act_bits=8,
            act_signed=True, use_pallas=False)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(j).view(np.uint32))


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4 i) & 7 of the 8-byte value y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        byte = (both >> np.uint64(8 * b)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * i)
    return out


def _widen4(bits, w0, w1):
    """``csrc/quant_matmul.cu:widen4``: the shifts, masks and the 4 x 4
    byte transpose, on uint32 arrays."""
    if bits == 2:
        m = np.uint32(0x03030303)
        f = [w0 & m, (w0 >> np.uint32(2)) & m, (w0 >> np.uint32(4)) & m,
             (w0 >> np.uint32(6)) & m]
    else:
        m = np.uint32(0x0F0F0F0F)
        f = [w0 & m, (w0 >> np.uint32(4)) & m, w1 & m,
             (w1 >> np.uint32(4)) & m]
    t0, t1 = _byte_perm(f[0], f[1], 0x5140), _byte_perm(f[2], f[3], 0x5140)
    t2, t3 = _byte_perm(f[0], f[1], 0x7362), _byte_perm(f[2], f[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _bytes(words):
    """uint32 words -> their 4 bytes, little-endian, on a new last axis."""
    return np.stack([(words >> np.uint32(8 * i)) & np.uint32(0xFF)
                     for i in range(4)], -1).astype(np.int64)


@pytest.mark.parametrize("bits", [2, 4])
def test_widening_byte_arithmetic_gives_unpacked_codes(bits):
    """The stream's ``widen4`` turns a group's packed words (4 columns a
    word) into each column's 4 K codes, biased; the tiles' ``widen`` turns
    16/per bytes read down a column into its 16 K codes, signed (the bias
    taken off bytewise by an add and an xor): both equal ``unpack_codes``
    on every K row of a 128-row tile of 8 columns."""
    k, n, half = TILE_BK, 8, 1 << (bits - 1)
    rng = np.random.default_rng(bits)
    codes = rng.integers(-half, half, size=(k, n)).astype(np.int8)
    packed = pack_codes(torch.from_numpy(codes), bits).numpy()
    want = unpack_codes(torch.from_numpy(packed), bits, k).numpy()
    assert np.array_equal(want, codes)
    rows_a_group = GROUP * bits // 8
    # stream: group g's packed rows, columns 4q .. 4q + 3 as one word
    words = packed.reshape(packed.shape[0], n // 4, 4).astype(np.uint32)
    words = (words[..., 0] | words[..., 1] << np.uint32(8)
             | words[..., 2] << np.uint32(16) | words[..., 3] << np.uint32(24))
    for g in range(k // GROUP):
        w0 = words[g * rows_a_group]
        w1 = words[g * rows_a_group + 1] if bits == 4 else np.zeros_like(w0)
        col = _widen4(bits, w0, w1)
        for q in range(n // 4):
            for c in range(4):
                got = _bytes(col[c][q]) - half
                assert np.array_equal(got, codes[4 * g:4 * g + 4, 4 * q + c])
    # tiles: column t's bytes down the raw tile, 16 codes a chunk
    to_signed = np.uint32(0x7E7E7E7E if bits == 2 else 0x78787878)
    for t in range(n):
        column = packed[:, t].astype(np.uint32)
        for j in range(TILE_BK // 16):
            if bits == 2:
                p = column[4 * j:4 * j + 4]
                b = np.uint32(p[0] | p[1] << 8 | p[2] << 16 | p[3] << 24)
                w = _widen4(2, np.array([b]), np.array([np.uint32(0)]))
            else:
                w = []
                for h in range(2):
                    p = column[8 * j + 4 * h:8 * j + 4 * h + 4]
                    b = np.array([p[0] | p[1] << 8 | p[2] << 16
                                  | p[3] << 24], np.uint32)
                    lo = b & np.uint32(0x0F0F0F0F)
                    hi = (b >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
                    w += [_byte_perm(lo, hi, 0x5140),
                          _byte_perm(lo, hi, 0x7362)]
            signed = [((wi + to_signed) & np.uint32(0xFFFFFFFF))
                      ^ np.uint32(0x80808080) for wi in w]
            got = np.concatenate([_bytes(s)[0] for s in signed])
            got = np.where(got > 127, got - 256, got)
            assert np.array_equal(got, codes[16 * j:16 * j + 16, t])


def test_int_stream_workspace_one_a_device_and_stream():
    """One zeroed workspace a (device, stream): another stream gets its
    own; growing doubles it and keeps the old buffer alive, so a graph
    captured on it still points at live memory."""
    saved = dict(qmm._INT_WS), list(qmm._INT_WS_KEPT)
    try:
        a = qmm._int_stream_ws("cpu", 11, 100)
        assert a.numel() == 100 and not a.any()
        assert qmm._int_stream_ws("cpu", 11, 64) is a
        b = qmm._int_stream_ws("cpu", 12, 64)
        assert b is not a and b.numel() == 64
        kept = len(qmm._INT_WS_KEPT)
        grown = qmm._int_stream_ws("cpu", 11, 150)
        assert grown.numel() == 200 and not grown.any()
        assert len(qmm._INT_WS_KEPT) == kept + 1
        assert qmm._INT_WS_KEPT[-1] is a
        assert qmm._int_stream_ws("cpu", 12, 64) is b
    finally:
        qmm._INT_WS.clear()
        qmm._INT_WS.update(saved[0])
        qmm._INT_WS_KEPT[:] = saved[1]
