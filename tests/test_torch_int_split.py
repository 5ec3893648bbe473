"""K5's and K6's two paths, as far as the CPU can hold them.

K5 (``int_matmul``, int8 codes) and K6 (``int_matmul_packed``, 2/4-bit
codes; both ``csrc/quant_matmul.cu``) pick a path from (M, N, K) alone
(``kernel_path``): at M <= ``DECODE_M`` a split-K stream over
``int_split_plan``'s chunks in one launch, whose splits add their exact
sums, each split into hi = v >> 12 and lo = v & 4095, into the two fp32
planes of a per-device workspace (``int_stream_ws_bytes``) that the last
block of each column tile rebuilds (4096 hi + lo), reads and zeroes; above
it int8 ``wgmma`` tiles, whose producer transposes the codes into a
K-major int8 tile. Every sum is exact, so a torch model of the stream's
sums (int8 codes, or the biased unsigned packed codes with the bias taken
off through each split's row sums; the splits' hi and lo parts added in
fp32 in any order) must give the plain version's bits and ``repro``'s op
run op by op, also where int8 column sums pass 2^24 and one fp32 plane
would round; and the byte arithmetic that transposes and widens the codes
(``transpose4``/``widen4`` of the stream, ``widen`` of the tiles), emulated
here in numpy, must give the codes. The workspace is kept one a device and
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
    int_matmul_op as j_int_matmul_op
from repro.kernels.quant_matmul.ops import \
    int_matmul_packed_op as j_int_matmul_packed_op
from repro.kernels.quant_matmul.ref import int_matmul_ref as j_int_matmul_ref
from repro.quant.pack import pack_codes as j_pack_codes
from repro_torch.core.quantizer import quantize_to_int
from repro_torch.kernels.quant_matmul import ops
from repro_torch.kernels.quant_matmul import quant_matmul as qmm
from repro_torch.kernels.quant_matmul.ref import (int_matmul_packed_ref,
                                                  int_matmul_ref,
                                                  quantize_act_ref)
from repro_torch.quant.pack import pack_codes, unpack_codes

GROUP = 4          # K rows of a stream group: one packed row at 2 bits
TILE_BK = 128      # K codes of a wgmma tile's stage
TILE_BN = 128      # columns of a wgmma tile
LO_BITS = 12       # a split's sum v enters the workspace as v >> 12, v & 4095


SERVING = [(2048, 2048), (5632, 2048), (32000, 2048), (256, 2048),
           (9216, 2304), (256000, 2304)]
ODD = [(37, 101), (300, 2050), (1, 64), (130, 4099), (3, 0), (64, 16385),
       (1, 1 << 24)]


@pytest.mark.parametrize("nk", SERVING + ODD)
def test_int_split_plan_covers_k_in_whole_packed_rows(nk):
    """Every K row in exactly one split, every split a whole number of
    packed rows at 2 and 4 bits (and of int8 rows); the plan is one
    function of (N, K), at most 4096 splits, so that the lo parts' fp32
    sums (below 4096 x 4095) stay exact."""
    n, k = nk
    splits, chunk = qmm.int_split_plan(n, k)
    assert chunk % GROUP == 0 and chunk >= min(16 * GROUP, max(k, 1))
    assert 1 <= splits <= qmm._INT_MAX_SPLITS == 4096
    assert splits * ((1 << LO_BITS) - 1) < 2**24
    assert (splits - 1) * chunk < max(k, 1) <= splits * chunk
    for bits in (2, 4, 8):
        per = 8 // bits
        assert chunk % per == 0   # a split starts on a stored row
    assert qmm.int_split_plan.__wrapped__(n, k) == (splits, chunk)
    if (n, k) in SERVING[:4]:
        # tinyllama's K6 sites fill the card, or stream K whole (the head)
        blocks = -(-n // 128) * splits
        assert blocks >= 64 and (splits == 1) == (n >= 32000)


def _stored(k, n, bits):
    """Zero codes as the kernels take them: (K, N) int8 at 8 bits, else
    (ceil(K/per), N) uint8."""
    if bits == 8:
        return torch.zeros((k, n), dtype=torch.int8)
    return torch.zeros((-(-k // (8 // bits)), n), dtype=torch.uint8)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_int_paths_workspace_and_tile_preparation(bits):
    """K5's and K6's path from (M, N, K) alone; the stream's workspace
    holds two planes (hi and lo) of 8 x 128 fp32 sums, 8 int32 row sums and
    an arrival counter a column tile, whatever the bits; the tiles quantize
    fp32 x (and copy int8 rows TMA cannot take) into their workspace, with
    int32 row sums, and pad unaligned code rows."""
    for m, n, k in [(8, 256, 2048), (1, 37, 101), (5, 3, 0), (9, 37, 0)]:
        assert qmm.kernel_path(m, n, k) == "stream"
    for m, n, k in [(9, 37, 101), (352, 5632, 2048), (512, 32000, 2048)]:
        assert qmm.kernel_path(m, n, k) == "wgmma"
    for n, tiles in [(1, 1), (128, 1), (129, 2), (32000, 250)]:
        assert qmm.int_stream_ws_bytes(n) \
            == 4 * tiles * (1 + 8 + 2 * 8 * 128)
    codes = _stored(2048, 5632, bits)
    xf = torch.zeros((512, 2048), dtype=torch.float32)
    assert qmm._int_tile_prep(xf, codes, 512, 5632, 2048, True) \
        == (True, False, 512 * 2048 + 2048)
    xq = torch.zeros((512, 2048), dtype=torch.int8)
    assert qmm._int_tile_prep(xq, codes, 512, 5632, 2048, False) \
        == (False, False, 0)
    odd = _stored(101, 37, bits)
    xo = torch.zeros((9, 101), dtype=torch.int8)
    # x: 9 rows of 112 bytes (1008, to 1024), row sums 36 (to 256), then
    # the code rows (101, 51 or 26) of 48 bytes
    assert qmm._int_tile_prep(xo, odd, 9, 37, 101, False) \
        == (True, True, 1024 + 256 + odd.shape[0] * 48)


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


def _plane_sums(parts, order):
    """The splits' int32 partials ``parts`` (splits, M, N) added as the
    stream adds them: each v as fp32 integers v >> 12 and v & 4095, each
    plane summed in fp32 in ``order``, then rebuilt as 4096 hi + lo in
    int32; also one fp32 plane of the whole partials, summed alike."""
    assert np.abs(parts).max(initial=0) < 2**31
    hi = np.zeros(parts.shape[1:], np.float32)
    lo = np.zeros(parts.shape[1:], np.float32)
    one = np.zeros(parts.shape[1:], np.float32)
    for s in order:
        hi += (parts[s] >> LO_BITS).astype(np.float32)
        lo += (parts[s] & ((1 << LO_BITS) - 1)).astype(np.float32)
        one += parts[s].astype(np.float32)
    rebuilt = (hi.astype(np.int64) << LO_BITS) + lo.astype(np.int64)
    return rebuilt, one


def stream_model(qx, codes, eff_scale, eff_bias, const, *, bits, k,
                 rowsum=None, order=None):
    """K5's and K6's stream in torch: each split of ``int_split_plan``
    multiplies the activation codes by the int8 codes, or by the biased
    (unsigned) packed codes and takes off 2^(b-1) times its own row sums;
    the splits' int32 sums go through ``_plane_sums`` in ``order`` (default
    reverse split order; any order gives the same integers), their row sums
    add in int32; then the plain version's epilogue, the row sums those of
    the fp32 loader unless ``rowsum`` is given."""
    m, n = qx.shape[0], codes.shape[1]
    splits, chunk = qmm.int_split_plan(n, k)
    half = 0 if bits == 8 else 1 << (bits - 1)
    c = codes if bits == 8 else unpack_codes(codes, bits, k)
    biased = c.numpy().astype(np.int64) + half
    a = qx.numpy().astype(np.int64)
    parts = np.zeros((splits, m, n), np.int64)
    rs = np.zeros((m,), np.int64)
    for s in range(splits):
        lo, hi = s * chunk, min(k, (s + 1) * chunk)
        part_rs = a[:, lo:hi].sum(1)
        parts[s] = a[:, lo:hi] @ biased[lo:hi] - half * part_rs[:, None]
        rs += part_rs
    acc, _ = _plane_sums(parts, reversed(range(splits)) if order is None
                         else order)
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
    tc = torch.from_numpy(codes)
    if bits == 8:
        stored = tc
        want = int_matmul_ref(qx, tc, es, eb, rowsum, const)
    else:
        stored = pack_codes(tc, bits)
        want = int_matmul_packed_ref(qx, stored, es, eb, rowsum, const,
                                     bits=bits, k=k)
    got = stream_model(qx, stored, es, eb, const, bits=bits, k=k)
    given = stream_model(qx, stored, es, eb, const, bits=bits, k=k,
                         rowsum=rowsum)
    return got, want, given, (x, codes, scale, bias, colsum, beta)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("mkn", [(3, 101, 37), (8, 2050, 300), (5, 64, 1),
                                 (1, 4099, 130)])
def test_stream_sums_bit_equal_to_plain(mkn, bits):
    """Ragged M, N and K (K no whole packed row; 1-33 splits): the model's
    bits equal the plain version's, with the fp32 loader's row sums and
    with int8 codes and their row sums given."""
    got, want, given, _ = _stream_case(mkn, bits)
    assert torch.equal(got, want) and torch.equal(given, want)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_stream_sums_bit_equal_to_repro_op_by_op(bits):
    """5 splits over a K of no whole packed row: the model's bits equal
    repro's ``int_matmul_op`` (8 bits) or ``int_matmul_packed_op`` run op
    by op (``jax.disable_jit``: the same fp32 operations in the same
    order)."""
    mkn = (8, 259, 37)
    got, _, _, (x, codes, scale, bias, colsum, beta) = _stream_case(mkn,
                                                                    bits)
    args = (jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(colsum),
            jnp.asarray(beta))
    with jax.disable_jit():
        if bits == 8:
            j = j_int_matmul_op(jnp.asarray(x), jnp.asarray(codes), *args,
                                act_bits=8, act_signed=True,
                                use_pallas=False)
        else:
            j = j_int_matmul_packed_op(
                jnp.asarray(x), j_pack_codes(jnp.asarray(codes), bits),
                *args, bits=bits, k=mkn[1], act_bits=8, act_signed=True,
                use_pallas=False)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(j).view(np.uint32))


@pytest.mark.parametrize("k", [2048, 5632, 9216])
def test_stream_hi_lo_rebuild_exact_where_fp32_rounds(k):
    """int8 activation and weight codes drawn in [100, 127] (random low
    bits; constant codes would sum to multiples of a power of two that
    fp32 may add exactly) at K 2048 (tinyllama's attention and mlp_gate),
    5632 (its mlp_down) and 9216 (gemma2's mlp_down), 8 rows, 2 column
    tiles: every column sum passes 2^24. One fp32 plane of the splits'
    partials rounds, in split order, in reverse and in a shuffled order;
    the hi/lo planes rebuild the exact int32 sums in each, and the model's
    output equals the plain version's bits and repro's ``int_matmul_ref``
    run op by op."""
    m, n = 8, 2 * TILE_BN
    rng = np.random.default_rng(k)
    qx = rng.integers(100, 128, size=(m, k)).astype(np.int8)
    codes = rng.integers(100, 128, size=(k, n)).astype(np.int8)
    es = rng.uniform(1e-6, 1e-5, size=(n,)).astype(np.float32)
    eb = rng.uniform(-1e-4, 1e-4, size=(n,)).astype(np.float32)
    const = rng.uniform(-0.5, 0.5, size=(n,)).astype(np.float32)
    a, c = qx.astype(np.int64), codes.astype(np.int64)
    exact = a @ c
    assert exact.min() > 2**24
    splits, chunk = qmm.int_split_plan(n, k)
    assert splits > 1
    parts = np.stack([a[:, s * chunk:(s + 1) * chunk]
                      @ c[s * chunk:(s + 1) * chunk] for s in range(splits)])
    for order in (range(splits), reversed(range(splits)),
                  rng.permutation(splits)):
        rebuilt, one = _plane_sums(parts, order)
        assert np.array_equal(rebuilt, exact)
        assert not np.array_equal(one.astype(np.int64), exact)
    tq, tc = torch.from_numpy(qx), torch.from_numpy(codes)
    tes, teb, tconst = (torch.from_numpy(v) for v in (es, eb, const))
    rowsum = tq.to(torch.int32).sum(dim=1).to(torch.float32)
    got = stream_model(tq, tc, tes, teb, tconst, bits=8, k=k,
                       order=rng.permutation(splits))
    assert torch.equal(got, int_matmul_ref(tq, tc, tes, teb, rowsum, tconst))
    with jax.disable_jit():
        j = j_int_matmul_ref(jnp.asarray(qx), jnp.asarray(codes),
                             jnp.asarray(es), jnp.asarray(eb),
                             jnp.asarray(rowsum.numpy()), jnp.asarray(const))
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


def _transpose4(f):
    """``csrc/quant_matmul.cu:transpose4``: K rows f[0..3] of 4 columns (a
    byte a column) to 4 columns of 4 K rows, on uint32 arrays."""
    t0, t1 = _byte_perm(f[0], f[1], 0x5140), _byte_perm(f[2], f[3], 0x5140)
    t2, t3 = _byte_perm(f[0], f[1], 0x7362), _byte_perm(f[2], f[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _widen4(bits, w0, w1):
    """``csrc/quant_matmul.cu:widen4``: the shifts and masks, then the 4 x 4
    byte transpose, on uint32 arrays."""
    if bits == 2:
        m = np.uint32(0x03030303)
        f = [w0 & m, (w0 >> np.uint32(2)) & m, (w0 >> np.uint32(4)) & m,
             (w0 >> np.uint32(6)) & m]
    else:
        m = np.uint32(0x0F0F0F0F)
        f = [w0 & m, (w0 >> np.uint32(4)) & m, w1 & m,
             (w1 >> np.uint32(4)) & m]
    return _transpose4(f)


def _bytes(words):
    """uint32 words -> their 4 bytes, little-endian, on a new last axis."""
    return np.stack([(words >> np.uint32(8 * i)) & np.uint32(0xFF)
                     for i in range(4)], -1).astype(np.int64)


def _words(rows):
    """uint8 rows (R, N) -> uint32 words (R, N / 4), 4 columns a word."""
    w = rows.reshape(rows.shape[0], -1, 4).astype(np.uint32)
    return (w[..., 0] | w[..., 1] << np.uint32(8) | w[..., 2] << np.uint32(16)
            | w[..., 3] << np.uint32(24))


def _tile_widen8(raw):
    """``csrc/quant_matmul.cu:itile::widen<8>`` on one raw tile (128 K rows
    x 128 columns of int8 as uint8): thread t = 32 w + l takes column quad
    l and, for unit u in 0, 1, chunk j = (2 w + u + (l / 2) % 4) % 8; its
    16 rows' words go through ``_transpose4`` 4 rows at a time, and column
    n = 4 l + c lands in chunk j ^ (n % 8) of B row n. Returns the B tile
    (128 x 128 bytes) and, for each 16-byte store of a quarter warp, the
    chunks its 8 lanes wrote."""
    words = _words(raw)                                  # (128, 32)
    bt = np.full((TILE_BN, 128), -1, np.int64)
    phases = []
    lane = np.arange(32)
    for w in range(4):
        for u in range(2):
            j = (2 * w + u + ((lane >> 1) & 3)) & 7
            v = words[16 * j[None, :] + np.arange(16)[:, None], lane]
            col = [_transpose4([v[4 * h + e] for e in range(4)])
                   for h in range(4)]
            for c in range(4):
                n = 4 * lane + c
                chunk = j ^ (n & 7)
                data = np.concatenate([_bytes(col[h][c]) for h in range(4)],
                                      axis=-1)           # (32, 16)
                for ln in range(32):
                    seg = bt[n[ln], 16 * chunk[ln]:16 * chunk[ln] + 16]
                    assert (seg == -1).all()             # written once
                    seg[:] = data[ln]
                phases += [chunk[8 * q:8 * q + 8] for q in range(4)]
    return bt, phases


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_widening_byte_arithmetic_gives_unpacked_codes(bits):
    """The stream's ``transpose4`` (int8) or ``widen4`` (packed) turns a
    group's words (4 columns a word) into each column's 4 K codes, biased
    at 2 and 4 bits; the tiles' ``widen`` turns 16/per bytes read down a
    column into its 16 K codes, signed (the bias taken off bytewise by an
    add and an xor), or, for int8 codes, 16 rows of words of 4 columns
    into those columns' chunks, each of the 128 x 8 chunks of the B tile
    written once at its swizzled place and the 8 lanes of every quarter
    warp's store on 8 distinct chunks (no bank conflict): all equal the
    codes on every K row of a 128-row tile (8 columns packed, 128 int8)."""
    k = TILE_BK
    n, half = (TILE_BN, 128) if bits == 8 else (8, 1 << (bits - 1))
    rng = np.random.default_rng(bits)
    codes = rng.integers(-half, half, size=(k, n)).astype(np.int8)
    if bits == 8:
        stored = codes.view(np.uint8)
        bias = 0
    else:
        stored = pack_codes(torch.from_numpy(codes), bits).numpy()
        want = unpack_codes(torch.from_numpy(stored), bits, k).numpy()
        assert np.array_equal(want, codes)
        bias = half
    rows_a_group = GROUP * bits // 8
    # stream: group g's stored rows, columns 4q .. 4q + 3 as one word
    words = _words(stored)
    for g in range(k // GROUP):
        if bits == 8:
            col = _transpose4([words[4 * g + r] for r in range(4)])
        else:
            w0 = words[g * rows_a_group]
            w1 = words[g * rows_a_group + 1] if bits == 4 \
                else np.zeros_like(w0)
            col = _widen4(bits, w0, w1)
        for q in range(n // 4):
            for c in range(4):
                got = _bytes(col[c][q]) - bias
                if bits == 8:
                    got = np.where(got > 127, got - 256, got)
                assert np.array_equal(got, codes[4 * g:4 * g + 4, 4 * q + c])
    if bits == 8:
        bt, phases = _tile_widen8(stored)
        for t in range(n):
            for j in range(TILE_BK // 16):
                ch = j ^ (t & 7)
                got = bt[t, 16 * ch:16 * ch + 16]
                got = np.where(got > 127, got - 256, got)
                assert np.array_equal(got, codes[16 * j:16 * j + 16, t])
        assert all(len(set(p.tolist())) == 8 for p in phases)
        return
    # tiles: column t's bytes down the raw tile, 16 codes a chunk
    to_signed = np.uint32(0x7E7E7E7E if bits == 2 else 0x78787878)
    for t in range(n):
        column = stored[:, t].astype(np.uint32)
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
