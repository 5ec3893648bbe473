"""K1/K4's two paths, as far as the CPU can hold them.

The CUDA kernels (``csrc/quant_matmul.cu``) take x in bf16 or fp32 and
pick a path from (M, N, K) alone: at M <= ``DECODE_M`` a split-K stream
of the codes over the host's ``split_plan`` (each split's 16 K slices
summed in a fixed order, the splits' partials added in split order), above
it bf16 ``wgmma`` tiles. These tests hold what the CPU reaches: the ops on
a bf16 activation against the same ops on its fp32 widening (bit for bit)
and against ``repro``'s ops, the split plan's cover of K, the stream's
summation order modelled in torch (``stream_model``) against the plain
version at ``K1_RTOL``, the wrapper's dtype checks, path tags and tile
preparation. The kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels.quant_matmul.ops import quant_matmul_op as j_qm_op
from repro.kernels.quant_matmul.ops import \
    quant_matmul_packed_op as j_qm_packed_op
from repro.quant.pack import pack_codes as j_pack_codes
from repro_torch.kernels.quant_matmul import quant_matmul as qmm
from repro_torch.kernels.quant_matmul.ops import (quant_matmul_op,
                                                  quant_matmul_packed_op)
from repro_torch.kernels.quant_matmul.ref import K1_RTOL, quant_matmul_ref
from repro_torch.quant.pack import pack_codes

# repro's ops against the port's plain versions: both sum K fp32 products
# in their own order (tests/test_torch_kernels.py, QM_RTOL)
QM_RTOL = 1e-5

# K slices of a stream block, slices a warp holds, groups of 4 K rows
SLICES, WARP_SLICES, GROUP = 16, 4, 4


def _operands(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    half = 1 << (bits - 1)
    codes = rng.integers(-half, half, size=(k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)
    bias = rng.uniform(-1e-3, 1e-3, size=(n,)).astype(np.float32)
    return x, codes, scale, bias


def _mag(x, codes, scale, bias):
    w = codes.astype(np.float32) * scale + bias
    return np.abs(x.float().numpy()) @ np.abs(w)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_bf16_activation_ops_equal_fp32_widening_and_repro(bits):
    """(2, 5, 101): 3-D activations, a K that is no whole packed row."""
    m, k, n = 10, 101, 37
    x, codes, scale, bias = _operands(m, k, n, bits, seed=bits)
    xb = x.to(torch.bfloat16).reshape(2, 5, k)
    xw = xb.to(torch.float32)
    sv, bv = torch.from_numpy(scale), torch.from_numpy(bias)
    jx = jnp.asarray(xw.numpy()).astype(jnp.bfloat16)
    if bits == 8:
        got = quant_matmul_op(xb, torch.from_numpy(codes), sv, bv)
        wide = quant_matmul_op(xw, torch.from_numpy(codes), sv, bv)
        want = np.asarray(j_qm_op(jx, jnp.asarray(codes), jnp.asarray(scale),
                                  jnp.asarray(bias), use_pallas=False))
    else:
        packed = pack_codes(torch.from_numpy(codes), bits)
        got = quant_matmul_packed_op(xb, packed, sv, bv, bits=bits, k=k)
        wide = quant_matmul_packed_op(xw, packed, sv, bv, bits=bits, k=k)
        want = np.asarray(j_qm_packed_op(
            jx, j_pack_codes(jnp.asarray(codes), bits), jnp.asarray(scale),
            jnp.asarray(bias), bits=bits, k=k, use_pallas=False))
    assert got.dtype == torch.float32 and got.shape == (2, 5, n)
    assert torch.equal(got, wide)
    tol = QM_RTOL * _mag(xw.reshape(m, k), codes, scale, bias) + 1e-7
    assert (np.abs(got.numpy() - want).reshape(m, n) <= tol).all()


SERVING = [(256, 2048), (2048, 2048), (5632, 2048), (2048, 5632),
           (32000, 2048), (1024, 2304), (2048, 2304), (2304, 2048),
           (9216, 2304), (2304, 9216), (256000, 2304)]
ODD = [(37, 101), (130, 640), (65, 66), (96, 64), (1, 1), (3, 0)]


@pytest.mark.parametrize("nk", SERVING + ODD)
def test_split_plan_covers_k_in_whole_packed_rows(nk):
    n, k = nk
    splits, chunk = qmm.split_plan(n, k)
    # whole groups of 4 K rows: whole packed rows at 2 bits (4 codes a
    # byte) and at 4 bits (2), in pairs (whole 16-byte loads of bf16 x);
    # every split starts inside K, the last ends at or past it, so each K
    # row is in exactly one split
    assert chunk > 0 and chunk % GROUP == 0 and chunk % 8 == 0
    assert splits >= 1 and (splits - 1) * chunk < max(k, 1) <= splits * chunk
    assert splits <= qmm._MAX_SPLITS
    # the plan is one function of (N, K): K1 and K4 at 2 and 4 bits sum in
    # one order (the wrappers pass no bits to it)
    assert qmm.split_plan.__wrapped__(n, k) == (splits, chunk)
    if (n, k) in SERVING[:6]:
        # the serving shapes fill the card: over 132 blocks (an H100's
        # SMs), or already one split per column tile of a wide matrix
        blocks = -(-n // qmm._STREAM_COLS) * splits
        assert blocks > 132 or splits == 1 or n >= 32000


def stream_model(x, codes, scale, bias, rowsum, n):
    """The stream path's sums in torch fp32: splits of ``chunk`` K rows;
    slice t of a split takes groups t, t + 16, ... in order, row by row;
    the 4 slices of a warp are summed pairwise ((0 + 1) + (2 + 3)), the
    four warps in turn; the combine's 8 lanes take splits y, y + 8, ... in
    turn and are summed as ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)); then
    the epilogue ``acc * scale + rowsum * bias`` (FMA: one rounding, taken
    in fp64)."""
    m, k = x.shape
    splits, chunk = qmm.split_plan(n, k)
    kp = splits * chunk
    xp = torch.zeros((m, kp), dtype=torch.float32)
    xp[:, :k] = x
    cp = torch.zeros((kp, n), dtype=torch.float32)
    cp[:k] = torch.from_numpy(codes).float()
    groups = chunk // GROUP
    acc = torch.zeros((splits, SLICES, m, n), dtype=torch.float32)
    for j in range(-(-groups // SLICES)):
        for t in range(SLICES):
            g = j * SLICES + t
            if g >= groups:
                continue
            for r in range(GROUP):
                ks = torch.arange(splits) * chunk + g * GROUP + r
                acc[:, t] = (acc[:, t] + xp[:, ks].T[:, :, None]
                             * cp[ks][:, None, :])
    warps = acc.reshape(splits, SLICES // WARP_SLICES, WARP_SLICES, m, n)
    warps = (warps[:, :, 0] + warps[:, :, 1]) + (warps[:, :, 2]
                                                 + warps[:, :, 3])
    block = warps[:, 0]
    for w in range(1, warps.shape[1]):
        block = block + warps[:, w]
    if splits == 1:
        total = block[0]
    else:
        lanes = []
        for y in range(8):
            v = torch.zeros((m, n), dtype=torch.float32)
            for s in range(y, splits, 8):
                v = v + block[s]
            lanes.append(v)
        total = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) \
            + ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7]))
    rb = (rowsum[:, None] * bias[None, :]).to(torch.float32)
    return (total.double() * scale.double() + rb.double()).to(torch.float32)


@pytest.mark.parametrize("mkn", [(8, 2048, 64), (4, 2304, 48), (3, 101, 37)])
def test_stream_order_within_k1_tolerance(mkn):
    """Tinyllama's K (2048, 128 splits of 16 rows at N 64), gemma2's (2304,
    144 splits) and a ragged K (7 splits); the model of the kernel's order against the plain
    version at the card tests' tolerance."""
    m, k, n = mkn
    x, codes, scale, bias = _operands(m, k, n, 8, seed=sum(mkn))
    sv, bv = torch.from_numpy(scale), torch.from_numpy(bias)
    got = stream_model(x, codes, sv, bv, x.sum(dim=1), n)
    want = quant_matmul_ref(x, torch.from_numpy(codes), sv, bv)
    mag = torch.from_numpy(_mag(x, codes, scale, bias))
    assert bool(((got - want).abs() <= K1_RTOL * mag + 1e-6).all())


def test_check_accepts_bf16_and_fp32_x_only():
    m, k, n = 4, 16, 8
    codes = torch.zeros((k, n), dtype=torch.int8)
    vec = torch.zeros((n,))
    rowsum = torch.zeros((m,))
    for dtype in qmm.X_DTYPES:
        qmm._check(torch.zeros((m, k), dtype=dtype), codes, vec, vec, rowsum)
    assert set(qmm.X_DTYPES) == {torch.float32, torch.bfloat16}
    for dtype in (torch.float16, torch.int8):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            qmm._check(torch.zeros((m, k), dtype=dtype), codes, vec, vec,
                       rowsum)


def test_paths_and_tile_preparation():
    """Serving shapes: decode (M 8 and 4) streams, prefill (M 64, 512,
    4608) runs the wgmma tiles; bf16 x with 16-byte rows goes in as it
    is, fp32 x and unaligned rows through the workspace."""
    for m, n, k in [(8, 256, 2048), (4, 9216, 2304), (1, 37, 101),
                    (5, 3, 0), (4608, 3, 0)]:
        assert qmm.kernel_path(m, n, k) == "stream"
    for m, n, k in [(64, 5632, 2048), (512, 256, 2048), (4608, 1024, 2304),
                    (9, 37, 100)]:
        assert qmm.kernel_path(m, n, k) == "wgmma"
    codes = torch.zeros((2048, 256), dtype=torch.int8)
    xb = torch.zeros((512, 2048), dtype=torch.bfloat16)
    assert qmm._tile_prep(xb, codes, 512, 256, 2048) == (False, False, 0)
    xf = torch.zeros((512, 2048), dtype=torch.float32)
    assert qmm._tile_prep(xf, codes, 512, 256, 2048) \
        == (True, False, 2 * 512 * 2048 * 2)
    odd = torch.zeros((26, 37), dtype=torch.uint8)  # K 101 at 2 bits
    x_odd = torch.zeros((9, 101), dtype=torch.bfloat16)
    # x: 9 rows of 104 bf16 (a 256-byte multiple), then 26 rows of 48 bytes
    assert qmm._tile_prep(x_odd, odd, 9, 37, 101) \
        == (True, True, 2048 + 26 * 48)
