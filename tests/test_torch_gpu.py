"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version at small and ragged shapes (K4 also bit for bit against K1 on the
unpacked codes, K3, K5 and K6 bit for bit against their plain versions, K6
also against K5 on the unpacked codes, K2c under a window that does not
bind bit for bit against K2a/K2b, K7 within a stated tolerance), the
serving engine on the card, uniform int8 and mixed 2/4/8-bit over an int4
KV pool, under a sliding window, with integer GEMMs (``act_bits=8``) and
on gemma2's local/global layers (prefill through K7), and CGMQ train steps
on the card against the same steps on the CPU.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it also runs where only PyTorch is installed (the
suite's conftest imports JAX, hence ``--noconftest``)::

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import warnings

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.controller import init_state
from repro_torch.core.gates import gate_to_bits
from repro_torch.core.quantizer import affine_grid
from repro_torch.data.synthetic import lm_tokens
from repro_torch.kernels.fake_quant.fake_quant import fake_quant
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, kernel_for)
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     k7_tolerance)
from repro_torch.kernels.fake_quant.ref import fake_quant_ref
from repro_torch.launch import steps as train_steps
from repro_torch.optim.adam import tree_leaves
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention, paged_attention_quant, paged_attention_quant_window,
    paged_attention_window)
from repro_torch.kernels.paged_attention.ref import (
    bf16_rounding_tolerance, paged_attention_ref)
from repro_torch.kernels.quant_matmul.quant_matmul import (
    int_matmul, int_matmul_packed, int_split_plan, kernel_path, quant_matmul,
    quant_matmul_packed)
from repro_torch.kernels.quant_matmul.ref import (K1_RTOL,
                                                  int_matmul_packed_ref,
                                                  int_matmul_ref,
                                                  quant_matmul_packed_ref,
                                                  quant_matmul_ref,
                                                  quantize_act_ref)
from repro_torch.models import transformer as tfm
from repro_torch.quant.kv import KVQuantSpec, dequantize_kv, quantize_kv
from repro_torch.quant.pack import pack_codes
from repro_torch.serving.engine import (Request, SamplingParams,
                                        ServingEngine,
                                        make_mixed_quant_state,
                                        make_uniform_quant_state)
from repro_torch.serving.window import WindowSpec

pytestmark = pytest.mark.gpu

# bf16 probabilities in the plain version vs fp32 in the kernel: 2^-8 max|v|
K2_TOL_FACTOR = 2.0 ** -8
# K2b against the plain version with q in fp32 (no bf16 rounding at all):
# the same fp32 function, sums in another order (see chip_smoke.py)
K2B_F32_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions are the references: keep fp32 products in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K1/K4 shapes (M, K, N): ragged ones, then the serving paths' own:
# tinyllama's decode attn_k/v and mlp_down, gemma2's decode mlp_gate (M 4),
# prefill rows at M 64 and 512 (tinyllama) and 4608 (gemma2 attn_k/v)
QMM_SHAPES = [(1, 64, 96), (8, 2048, 256), (9, 100, 37), (64, 640, 130),
              (130, 64, 65), (8, 5632, 2048), (4, 2304, 9216),
              (64, 2048, 5632), (512, 2048, 256), (4608, 2304, 1024)]
QMM_PACKED_SHAPES = [(3, 101, 37), (1, 64, 96), (8, 2048, 256),
                     (64, 640, 130), (130, 66, 65), (8, 5632, 2048),
                     (4, 2304, 9216), (64, 2048, 5632), (512, 2048, 256),
                     (4608, 2304, 1024)]


def _qmm_operands(mkn, bits, x_dtype, cuda, seed):
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=cuda).to(x_dtype)
    half = 1 << (bits - 1)
    codes = torch.randint(-half, half, (k, n), generator=g, device=cuda,
                          dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=cuda) * 0.01 + 1e-3
    bias = (torch.rand((n,), generator=g, device=cuda) - 0.5) * 1e-3
    rowsum = x.sum(dim=1, dtype=torch.float32)
    mag = x.float().abs() @ (codes.float() * scale + bias).abs()
    return x, codes, scale, bias, rowsum, mag


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", QMM_SHAPES)
def test_quant_matmul_kernel_matches_plain(cuda, mkn, x_dtype):
    """K1 on x in fp32 and in bf16 (the serving path) against its plain
    version at K1_RTOL of |x| @ |w|; two calls give the same bits."""
    x, codes, scale, bias, rowsum, mag = _qmm_operands(
        mkn, 8, x_dtype, cuda, sum(mkn))
    before = quant_matmul.launches
    got = quant_matmul(x, codes, scale, bias, rowsum)
    again = quant_matmul(x, codes, scale, bias, rowsum)
    want = quant_matmul_ref(x, codes, scale, bias)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 2
    assert bool(((got - want).abs() <= K1_RTOL * mag + 1e-6).all())
    assert torch.equal(got, again)
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_paged_attention_kernel_matches_plain(cuda, hd, pool_dtype, softcap):
    b, kvh, grp, bs, mb = 5, 2, 4, 8, 6
    nb = b * mb + 1
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, mb * bs, b).astype(np.int32)
    pos[0], pos[1] = mb * bs - 1, 0
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        table[i, :p // bs + 1] = perm[i * mb:i * mb + p // bs + 1]
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((b, kvh, grp, hd), generator=g, device=cuda).to(
        torch.bfloat16)
    kp = torch.randn((nb, bs, kvh, hd), generator=g, device=cuda).to(
        pool_dtype)
    vp = torch.randn((nb, bs, kvh, hd), generator=g, device=cuda).to(
        pool_dtype)
    args = (q, kp, vp, torch.from_numpy(table).to(cuda),
            torch.from_numpy(pos).to(cuda))
    got = paged_attention(*args, softcap=softcap)
    want = paged_attention_ref(*args, softcap=softcap)
    torch.cuda.synchronize()
    tol = K2_TOL_FACTOR * float(vp.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("mkn", QMM_PACKED_SHAPES)
def test_quant_matmul_packed_kernel_matches_plain_and_k1(cuda, mkn, bits,
                                                         x_dtype):
    """K4 on pack(c) against its plain version, bit for bit against K1 on
    c (the same K order on both paths: the stream's split plan and the
    tile's bf16 codes do not depend on bits), and two calls bit-identical;
    x in fp32 and bf16."""
    m, k, n = mkn
    x, codes, scale, bias, rowsum, mag = _qmm_operands(
        mkn, bits, x_dtype, cuda, sum(mkn) + bits)
    packed = pack_codes(codes, bits)
    before = quant_matmul_packed.launches
    got = quant_matmul_packed(x, packed, scale, bias, rowsum, bits=bits, k=k)
    again = quant_matmul_packed(x, packed, scale, bias, rowsum, bits=bits,
                                k=k)
    want = quant_matmul_packed_ref(x, packed, scale, bias, bits=bits, k=k)
    k1 = quant_matmul(x, codes, scale, bias, rowsum)
    torch.cuda.synchronize()
    assert quant_matmul_packed.launches == before + 2
    assert bool(((got - want).abs() <= K1_RTOL * mag + 1e-6).all())
    assert torch.equal(got, k1)
    assert torch.equal(got, again)


@pytest.mark.parametrize("mkn,path", [
    ((8, 2048, 256), "stream"), ((8, 5632, 2048), "stream"),
    ((4, 2304, 9216), "stream"), ((64, 2048, 5632), "wgmma"),
    ((512, 2048, 256), "wgmma"), ((4608, 2304, 1024), "wgmma")])
def test_serving_shapes_take_the_new_paths(cuda, mkn, path):
    """The split-K stream at decode (M 4 and 8), the wgmma tiles at
    prefill: the path each wrapper's last launch ran (``.path``), for K1
    and K4 alike."""
    m, k, n = mkn
    x, codes, scale, bias, rowsum, _ = _qmm_operands(
        mkn, 4, torch.bfloat16, cuda, 0)
    assert kernel_path(m, n, k) == path
    quant_matmul(x, codes, scale, bias, rowsum)
    quant_matmul_packed(x, pack_codes(codes, 4), scale, bias, rowsum,
                        bits=4, k=k)
    torch.cuda.synchronize()
    assert quant_matmul.path == quant_matmul_packed.path == path


@pytest.mark.parametrize("act_bits", [8, 4])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("mkn", [(3, 101, 37), (1, 64, 96), (8, 2048, 256),
                                 (64, 640, 130), (130, 66, 65),
                                 (512, 2048, 256), (8, 2050, 300),
                                 (5, 4099, 130), (8, 2048, 5632),
                                 (9, 1001, 77), (300, 2050, 250),
                                 (9, 0, 37), (2, 333, 130),
                                 (4, 2048, 2048)])
def test_int_matmul_kernels_bit_equal_to_plain(cuda, mkn, bits, act_bits):
    """K5 (8-bit codes) and K6 (2/4-bit codes packed along K) with both
    loaders: int8 activation codes with their row sums, and fp32
    activations quantized in the kernel on a signed and an unsigned grid.
    Each bit for bit against its plain version (int32 sums are exact in any
    order; the epilogue is rounded as the plain version rounds it), and K6
    bit for bit against K5 on the unpacked codes, both on their two paths
    (M <= 8 or K = 0 the split-K stream, whose one launch leaves its
    workspace zero: a second call gives the same bits; above, the int8
    wgmma tiles), with ragged M, N and K (N no multiple of 16, K no whole
    packed row) and M 1, 2, 4, 8, 9 and 512."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(sum(mkn) + bits + act_bits)
    x = torch.randn((m, k), generator=g, device=cuda) * 1.5
    half = 1 << (bits - 1)
    codes = torch.randint(-half, half, (k, n), generator=g, device=cuda,
                          dtype=torch.int8)
    es = torch.rand((n,), generator=g, device=cuda) * 1e-3 + 1e-5
    eb = (torch.rand((n,), generator=g, device=cuda) - 0.5) * 2e-4
    cst = torch.rand((n,), generator=g, device=cuda) - 0.5
    before = (int_matmul.launches, int_matmul_packed.launches)
    for signed in (True, False):
        beta = torch.tensor(2.0, device=cuda)
        alpha = -beta if signed else torch.zeros_like(beta)
        s, _ = affine_grid(act_bits, beta, signed)
        grid = torch.stack([alpha, beta, s])
        qx, rowsum = quantize_act_ref(x, grid, act_bits)
        want = int_matmul_ref(qx, codes, es, eb, rowsum, cst)
        k5 = int_matmul(qx, codes, es, eb, rowsum, cst)
        k5f = int_matmul(x, codes, es, eb, None, cst, act=(grid, act_bits))
        k5again = int_matmul(x, codes, es, eb, None, cst,
                             act=(grid, act_bits))
        torch.cuda.synchronize()
        assert int_matmul.path == kernel_path(m, n, k)
        assert torch.equal(k5, want) and torch.equal(k5f, want)
        assert torch.equal(k5again, k5f)
        if bits < 8:
            packed = pack_codes(codes, bits)
            wantp = int_matmul_packed_ref(qx, packed, es, eb, rowsum, cst,
                                          bits=bits, k=k)
            k6 = int_matmul_packed(qx, packed, es, eb, rowsum, cst,
                                   bits=bits, k=k)
            k6f = int_matmul_packed(x, packed, es, eb, None, cst, bits=bits,
                                    k=k, act=(grid, act_bits))
            again = int_matmul_packed(x, packed, es, eb, None, cst,
                                      bits=bits, k=k, act=(grid, act_bits))
            torch.cuda.synchronize()
            assert int_matmul_packed.path == kernel_path(m, n, k)
            assert torch.equal(wantp, want)
            assert torch.equal(k6, want) and torch.equal(k6f, want)
            assert torch.equal(again, k6f)
    assert int_matmul.launches == before[0] + 6
    assert int_matmul_packed.launches == before[1] + (6 if bits < 8 else 0)


def _worst_case_operands(m, k, n, device):
    """Activation and weight codes drawn in [100, 127] (random low bits):
    every column sum of the int8 product passes 2^24 (at K 2048, at least
    2.0e7), where one fp32 plane of split sums would round. The fp32
    activations lie on the signed 8-bit grid's points of those codes."""
    g = torch.Generator(device=device).manual_seed(k + m)
    beta = torch.tensor(4.0, device=device)
    s, _ = affine_grid(8, beta, True)
    grid = torch.stack([-beta, beta, s])
    c = torch.randint(100, 128, (m, k), generator=g, device=device)
    x = (c + 128).to(torch.float32) * s - beta
    codes = torch.randint(100, 128, (k, n), generator=g, device=device,
                          dtype=torch.int8)
    es = torch.rand((n,), generator=g, device=device) * 1e-5 + 1e-6
    eb = (torch.rand((n,), generator=g, device=device) - 0.5) * 2e-4
    cst = torch.rand((n,), generator=g, device=device) - 0.5
    return x, grid, codes, es, eb, cst


@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("k", [2048, 5632, 9216])
def test_int_matmul_bit_equal_where_column_sums_pass_2_24(cuda, k, m):
    """K5 on the worst-case operand (codes in [100, 127]) at tinyllama's and
    gemma2's K, on the stream (M 8: its splits' sums added as hi and lo
    parts, each exact in fp32) and the tiles (M 512): bit for bit against
    the plain version with both loaders, two calls identical."""
    n = 300
    x, grid, codes, es, eb, cst = _worst_case_operands(m, k, n, cuda)
    qx, rowsum = quantize_act_ref(x, grid, 8)
    assert int(qx.min()) >= 99
    assert float((qx.double() @ codes.double()).min()) > 2**24
    want = int_matmul_ref(qx, codes, es, eb, rowsum, cst)
    got = int_matmul(qx, codes, es, eb, rowsum, cst)
    fused = int_matmul(x, codes, es, eb, None, cst, act=(grid, 8))
    again = int_matmul(x, codes, es, eb, None, cst, act=(grid, 8))
    torch.cuda.synchronize()
    assert int_matmul.path == kernel_path(m, n, k)
    if m <= 8:
        assert int_split_plan(n, k)[0] > 1
    assert torch.equal(got, want) and torch.equal(fused, want)
    assert torch.equal(again, fused)


def test_int_matmul_packed_workspace_per_stream_and_in_graphs(cuda):
    """K5's and K6's decode stream share one self-zeroing workspace a
    stream: K5 and K6 calls interleaved on two streams, and CUDA graphs
    captured after eager calls on another stream (the workspace then made
    inside the capture), give the plain versions' bits, replay after
    replay."""
    m, k, n, bits = 8, 2050, 300, 4
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    codes = torch.randint(-8, 8, (k, n), generator=g, device=cuda,
                          dtype=torch.int8)
    codes8 = torch.randint(-128, 128, (k, n), generator=g, device=cuda,
                           dtype=torch.int8)
    packed = pack_codes(codes, bits)
    es = torch.rand((n,), generator=g, device=cuda) * 1e-3 + 1e-5
    eb = (torch.rand((n,), generator=g, device=cuda) - 0.5) * 2e-4
    cst = torch.rand((n,), generator=g, device=cuda) - 0.5
    beta = torch.tensor(2.0, device=cuda)
    grid = torch.stack([-beta, beta, affine_grid(8, beta, True)[0]])
    qx, rowsum = quantize_act_ref(x, grid, 8)
    want = int_matmul_packed_ref(qx, packed, es, eb, rowsum, cst, bits=bits,
                                 k=k)
    want8 = int_matmul_ref(qx, codes8, es, eb, rowsum, cst)

    def call():
        return int_matmul_packed(x, packed, es, eb, None, cst, bits=bits,
                                 k=k, act=(grid, 8))

    def call8():
        return int_matmul(x, codes8, es, eb, None, cst, act=(grid, 8))

    assert kernel_path(m, n, k) == "stream"
    assert int_split_plan(n, k)[0] > 1
    main, pair = torch.cuda.current_stream(), (torch.cuda.Stream(),
                                               torch.cuda.Stream())
    outs = []
    for s in pair:
        s.wait_stream(main)
    for _ in range(20):
        for s in pair:
            with torch.cuda.stream(s):
                outs.append((call(), want))
                outs.append((call8(), want8))
    for s in pair:
        main.wait_stream(s)
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in outs)
    for fn, w in ((call, want), (call8, want8)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        for _ in range(3):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, w)
        assert torch.equal(fn(), w)


def _quant_pools(bits, hd, b=5, kvh=2, bs=8, mb=6, seed=0):
    """Random K/V quantized by the port's codec, a table with every -1 past
    pos, and the dequantized pools."""
    nb = b * mb + 1
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, mb * bs, b).astype(np.int32)
    pos[0], pos[1] = mb * bs - 1, 0
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        table[i, :p // bs + 1] = perm[i * mb:i * mb + p // bs + 1]
    spec = KVQuantSpec(bits=bits, group_size=min(32, hd), head_dim=hd)
    g = torch.Generator(device="cuda").manual_seed(seed)
    k, v = (quantize_kv(torch.randn((nb, bs, kvh, hd), generator=g,
                                    device="cuda"), spec) for _ in range(2))
    deq = [dequantize_kv(c, sc, spec) for c, sc in (k, v)]
    return (k, v, torch.from_numpy(table).cuda(),
            torch.from_numpy(pos).cuda(), deq)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_paged_attention_quant_kernel_matches_plain(cuda, bits, hd, softcap):
    (kc, ks), (vc, vs), table, pos, (kd, vd) = _quant_pools(bits, hd,
                                                            seed=hd + bits)
    grp = 4
    g = torch.Generator(device=cuda).manual_seed(bits)
    q = torch.randn((table.shape[0], kc.shape[2], grp, hd), generator=g,
                    device=cuda).to(torch.bfloat16)
    before = paged_attention_quant.launches
    got = paged_attention_quant(q, kc, vc, ks, vs, table, pos,
                                softcap=softcap)
    want = paged_attention_ref(q, kc, vc, table, pos, softcap=softcap,
                               k_scale=ks, v_scale=vs)
    f32 = paged_attention_ref(q.float(), kc, vc, table, pos, softcap=softcap,
                              k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert paged_attention_quant.launches == before + 1
    tol = bf16_rounding_tolerance(q, kd, vd, table, pos)
    assert float((got - want).abs().max()) <= tol
    assert float((got - f32).abs().max()) <= K2B_F32_RTOL * float(
        vd.abs().max())


# (window, sinks in tokens) at bs = 8, positions up to 47: binding with
# sinks, binding without, sinks covering a block in part, not binding
WINDOW_CASES = [(12, 8), (12, 0), (13, 11), (4096, 0)]


def _evict(table, pos, window, sinks, bs=8):
    """The table after the engine's out-of-window eviction: blocks wholly
    outside the sinks and the window are -1, so every -1 lies outside the
    live span (where the plain version masks what it gathers)."""
    sink_blocks = -(-sinks // bs)
    out = table.clone()
    for i, p in enumerate(pos.tolist()):
        out[i, sink_blocks:max((p - window + 1) // bs, sink_blocks)] = -1
    return out


@pytest.mark.parametrize("window, sinks", WINDOW_CASES)
@pytest.mark.parametrize("pool", ["bf16", "fp32", "int8", "int4"])
def test_paged_attention_window_kernel_matches_plain(cuda, pool, window,
                                                     sinks):
    """K2c on every pool kind against its plain version, at K2a's and
    K2b's tolerances; under a window that does not bind it gives K2a's or
    K2b's result bit for bit, and each launch counts as K2c's only."""
    grp, hd = 4, 64
    if pool in ("int8", "int4"):
        (kc, ks), (vc, vs), table, pos, (kd, vd) = _quant_pools(
            int(pool[-1]), hd, seed=window + sinks)
        scales = {"k_scale": ks, "v_scale": vs}
        wrapper, plain_kernel = paged_attention_quant_window, \
            paged_attention_quant
    else:
        (kc, vc, table, pos), scales = _float_pools(
            getattr(torch, {"bf16": "bfloat16", "fp32": "float32"}[pool]),
            hd, seed=window + sinks), {}
        kd, vd = kc.float(), vc.float()
        wrapper, plain_kernel = paged_attention_window, paged_attention
    table = _evict(table, pos, window, sinks)
    g = torch.Generator(device=cuda).manual_seed(window)
    q = torch.randn((table.shape[0], kc.shape[2], grp, hd), generator=g,
                    device=cuda).to(torch.bfloat16)
    win = {"window": window, "sinks": sinks}
    counts = (wrapper.launches, plain_kernel.launches)
    if scales:
        got = wrapper(q, kc, vc, scales["k_scale"], scales["v_scale"], table,
                      pos, **win)
    else:
        got = wrapper(q, kc, vc, table, pos, **win)
    want = paged_attention_ref(q, kc, vc, table, pos, **win, **scales)
    torch.cuda.synchronize()
    assert (wrapper.launches, plain_kernel.launches) \
        == (counts[0] + 1, counts[1])
    if scales:
        f32 = paged_attention_ref(q.float(), kc, vc, table, pos, **win,
                                  **scales)
        tol = bf16_rounding_tolerance(q, kd, vd, table, pos, **win)
        assert float((got - f32).abs().max()) <= K2B_F32_RTOL * float(
            vd.abs().max())
    else:
        tol = K2_TOL_FACTOR * float(vd.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol
    if window > int(pos.max()):
        unwindowed = plain_kernel(q, kc, vc, *scales.values(), table, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, unwindowed)


def _float_pools(dtype, hd, b=5, kvh=2, bs=8, mb=6, seed=0):
    """Random float pools and a table with every -1 past pos."""
    nb = b * mb + 1
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, mb * bs, b).astype(np.int32)
    pos[0], pos[1] = mb * bs - 1, 0
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        table[i, :p // bs + 1] = perm[i * mb:i * mb + p // bs + 1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    kp, vp = (torch.randn((nb, bs, kvh, hd), generator=g,
                          device="cuda").to(dtype) for _ in range(2))
    return kp, vp, torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()


# the split walk at gemma2's decode shape: head_dim 256, 2 query heads a
# KV head, 16-token blocks, 288 a row, chunks of 64 tokens (split_plan).
# Rows end on a chunk boundary (4543: 71 chunks; 63: one), one token past
# one (4544, 64), at 0, and inside a single chunk (40); -1 past each pos
LONG_POSITIONS = [4543, 4544, 0, 40, 63, 64]
# (window, sinks): none (K2a/K2b); a window that binds mid-chunk and
# mid-block with sinks covering part of a block (20 of 32 tokens); a
# window that cannot bind (the table's span: K2a's chunks and bits)
LONG_WINDOWS = [(None, 0), (4090, 20), (4608, 0)]


def _long_inputs(pool, window, sinks, seed=0):
    """q, pools (and scales), dequantized pools, table and pos at
    LONG_POSITIONS; the table mapped up to each pos, less the blocks the
    engine evicts under ``window``."""
    b, kvh, grp, hd, bs, mb = len(LONG_POSITIONS), 2, 2, 256, 16, 288
    nb = b * mb + 1
    rng = np.random.default_rng(seed)
    pos = np.asarray(LONG_POSITIONS, np.int32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        table[i, :p // bs + 1] = perm[i * mb:i * mb + p // bs + 1]
    table, pos = torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()
    if window is not None:
        table = _evict(table, pos, window, sinks, bs)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, kvh, grp, hd), generator=g, device="cuda").to(
        torch.bfloat16)
    kv = [torch.randn((nb, bs, kvh, hd), generator=g, device="cuda")
          for _ in range(2)]
    if pool in ("int8", "int4"):
        spec = KVQuantSpec(bits=int(pool[-1]), group_size=32, head_dim=hd)
        (kc, ks), (vc, vs) = (quantize_kv(x, spec) for x in kv)
        return (q, (kc, vc), {"k_scale": ks, "v_scale": vs},
                (dequantize_kv(kc, ks, spec), dequantize_kv(vc, vs, spec)),
                table, pos)
    dt = torch.bfloat16 if pool == "bf16" else torch.float32
    pools = tuple(x.to(dt) for x in kv)
    return q, pools, {}, tuple(x.float() for x in pools), table, pos


@pytest.mark.parametrize("window, sinks", LONG_WINDOWS)
@pytest.mark.parametrize("pool", ["bf16", "fp32", "int8", "int4"])
def test_paged_attention_split_walk_on_long_rows(cuda, pool, window, sinks):
    """K2a/K2b (``window`` None) and K2c at gemma2's decode shape against
    the plain version, at K2a's and K2b's tolerances, and against the plain
    version in fp32 (it rounds nothing to bf16: the kernel's own function)
    at K2b's fp32 tolerance, every pool; two calls give the same bits and
    count one launch each; under a window that cannot bind K2c gives K2a's
    or K2b's bits."""
    q, pools, scales, (kd, vd), table, pos = _long_inputs(pool, window,
                                                          sinks)
    quant = bool(scales)
    plain_kernel = paged_attention_quant if quant else paged_attention
    win = {} if window is None else {"window": window, "sinks": sinks}
    if window is None:
        wrapper = plain_kernel
    else:
        wrapper = paged_attention_quant_window if quant \
            else paged_attention_window
    args = (q, *pools, *scales.values(), table, pos)
    before = wrapper.launches
    got, again = wrapper(*args, **win), wrapper(*args, **win)
    want = paged_attention_ref(q, *pools, table, pos, **win, **scales)
    f32 = paged_attention_ref(q.float(), *pools, table, pos, **win,
                              **scales)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(got, again)
    if quant:
        tol = bf16_rounding_tolerance(q, kd, vd, table, pos, **win)
    else:
        tol = K2_TOL_FACTOR * float(vd.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol
    assert float((got - f32).abs().max()) <= K2B_F32_RTOL * float(
        vd.abs().max())
    if window is not None and window >= table.shape[1] * kd.shape[1]:
        unwindowed = plain_kernel(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, unwindowed)


# (G, head_dim, block size): more query heads than one split block scores
# (two head tiles), a head dim that leaves lanes idle (96: 12 of 16), one
# token a block (chunks of 64 blocks), the narrowest head (8: 32 tokens a
# warp step), query heads of 6 (a tile of 8 padded) over blocks wider than
# a chunk (128 tokens: one block a split)
ODD_SHAPES = [(10, 64, 8), (3, 96, 8), (2, 128, 1), (1, 8, 32),
              (6, 256, 128)]


@pytest.mark.parametrize("kind", ["K2a", "K2b", "K2c"])
@pytest.mark.parametrize("shape", ODD_SHAPES,
                         ids=[f"g{g}-hd{hd}-bs{bs}" for g, hd, bs in
                              ODD_SHAPES])
def test_paged_attention_split_walk_on_odd_shapes(cuda, shape, kind):
    """K2a (bf16 pool), K2b (int8 pool) and K2c (bf16 pool, window of 70
    tokens with 5 sinks) against the plain version, and against it in
    fp32, at the shapes the main paths do not reach, rows up to ~300
    tokens."""
    g, hd, bs = shape
    b, kvh, mb = 3, 2, -(-320 // bs)
    nb = b * mb + 1
    rng = np.random.default_rng(g * hd + bs)
    pos = np.asarray([mb * bs - 1, 0, 131], np.int32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        table[i, :p // bs + 1] = perm[i * mb:i * mb + p // bs + 1]
    table, pos = torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()
    win = {}
    if kind == "K2c":
        win = {"window": 70, "sinks": 5}
        table = _evict(table, pos, 70, 5, bs)
    gen = torch.Generator(device="cuda").manual_seed(g + hd + bs)
    q = torch.randn((b, kvh, g, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv = [torch.randn((nb, bs, kvh, hd), generator=gen, device="cuda")
          for _ in range(2)]
    if kind == "K2b":
        spec = KVQuantSpec(bits=8, group_size=8, head_dim=hd)
        (kc, ks), (vc, vs) = (quantize_kv(x, spec) for x in kv)
        got = paged_attention_quant(q, kc, vc, ks, vs, table, pos)
        want, f32 = (paged_attention_ref(qq, kc, vc, table, pos, k_scale=ks,
                                         v_scale=vs) for qq in (q, q.float()))
        vd = dequantize_kv(vc, vs, spec)
        tol = bf16_rounding_tolerance(q, dequantize_kv(kc, ks, spec), vd,
                                      table, pos)
    else:
        kp, vd = (x.to(torch.bfloat16) for x in kv)
        fn = paged_attention_window if win else paged_attention
        got = fn(q, kp, vd, table, pos, **win)
        want, f32 = (paged_attention_ref(qq, kp, vd, table, pos, **win)
                     for qq in (q, q.float()))
        tol = K2_TOL_FACTOR * float(vd.abs().max()) + 1e-5
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= tol
    assert float((got - f32).abs().max()) <= K2B_F32_RTOL * float(
        vd.abs().max())


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_windowed_engine_on_card_runs_through_k2c(cuda, kv_dtype):
    """ServingEngine(attention_window=WindowSpec(12, 1)) on the card: every
    decode attention is a K2c launch (none of K2a/K2b), one sync per
    tick, and every block back at the end."""
    cfg = get_smoke_config("tinyllama-1.1b")
    params = _to(tfm.init_params(cfg, 0, device="cpu"), cuda)
    eng = ServingEngine(cfg, params, slots=3, max_seq=64, kv_dtype=kv_dtype,
                        attention_window=WindowSpec(12, 1),
                        quant_state=make_uniform_quant_state(cfg, params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (3, 30, 20, 9)]
    k2c = paged_attention_window if kv_dtype == "bf16" \
        else paged_attention_quant_window
    for fn in (paged_attention, paged_attention_quant, paged_attention_window,
               paged_attention_quant_window):
        fn.launches = 0
    res = eng.generate(prompts, SamplingParams(max_new=12))
    st = eng.stats
    assert all(r.finish_reason == "length" and len(r.tokens) == 12
               and all(0 <= t < cfg.vocab_size for t in r.tokens)
               for r in res)
    assert st["tick_syncs"] == st["decode_ticks"]
    assert k2c.launches == cfg.n_layers * st["decode_ticks"]
    assert paged_attention.launches == paged_attention_quant.launches == 0
    assert int(eng.alloc["n_free"]) == eng.num_blocks - 1


def test_engine_on_card_runs_through_the_kernels(cuda):
    cfg = get_smoke_config("tinyllama-1.1b")
    params = _to(tfm.init_params(cfg, 0, device="cpu"), cuda)
    eng = ServingEngine(cfg, params, slots=3, max_seq=64,
                        quant_state=make_uniform_quant_state(cfg, params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (3, 9, 20, 7)]
    quant_matmul.launches = paged_attention.launches = 0
    res = eng.generate(prompts, SamplingParams(max_new=5))
    st = eng.stats
    assert all(r.finish_reason == "length" and len(r.tokens) == 5
               and all(0 <= t < cfg.vocab_size for t in r.tokens)
               for r in res)
    assert st["tick_syncs"] == st["decode_ticks"]
    assert quant_matmul.launches == (7 * cfg.n_layers + 1) * (
        st["prefill_forwards"] + st["decode_ticks"])
    assert paged_attention.launches == cfg.n_layers * st["decode_ticks"]


def test_mixed_engine_over_int4_kv_on_card(cuda):
    """The mixed 2/4/8-bit artifact over an int4 pool: every 2/4-bit site
    goes through K4, every 8-bit one through K1, attention through K2b."""
    cfg = get_smoke_config("tinyllama-1.1b")
    params = _to(tfm.init_params(cfg, 0, device="cpu"), cuda)
    eng = ServingEngine(cfg, params, slots=3, max_seq=64, kv_dtype="int4",
                        quant_state=make_mixed_quant_state(cfg, params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (3, 9, 20, 7)]
    quant_matmul.launches = quant_matmul_packed.launches = 0
    paged_attention.launches = paged_attention_quant.launches = 0
    res = eng.generate(prompts, SamplingParams(max_new=5))
    st = eng.stats
    assert all(r.finish_reason == "length" and len(r.tokens) == 5
               and all(0 <= t < cfg.vocab_size for t in r.tokens)
               for r in res)
    assert st["tick_syncs"] == st["decode_ticks"]
    forwards = st["prefill_forwards"] + st["decode_ticks"]
    assert quant_matmul.launches == 2 * cfg.n_layers * forwards
    assert quant_matmul_packed.launches == (5 * cfg.n_layers + 1) * forwards
    assert paged_attention_quant.launches == cfg.n_layers * st["decode_ticks"]
    assert paged_attention.launches == 0


@pytest.mark.parametrize("state, kv_dtype", [("uniform", "bf16"),
                                             ("mixed", "int4")])
def test_int_engine_on_card_runs_through_k5_k6(cuda, state, kv_dtype):
    """ServingEngine(act_bits=8) on the card: every GEMM of the uniform
    artifact is a K5 launch; the mixed artifact's 8-bit sites run K5 and
    its packed 2/4-bit sites K6; K1 and K4 never launch; attention goes
    through K2a (bf16 pool) or K2b (int4 pool); one sync per tick; every
    GEMM input is served integer."""
    cfg = get_smoke_config("tinyllama-1.1b")
    params = _to(tfm.init_params(cfg, 0, device="cpu"), cuda)
    make = make_uniform_quant_state if state == "uniform" \
        else make_mixed_quant_state
    eng = ServingEngine(cfg, params, slots=3, max_seq=64, kv_dtype=kv_dtype,
                        act_bits=8, quant_state=make(cfg, params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (3, 9, 20, 7)]
    kernels = (quant_matmul, quant_matmul_packed, int_matmul,
               int_matmul_packed, paged_attention, paged_attention_quant)
    for fn in kernels:
        fn.launches = 0
    res = eng.generate(prompts, SamplingParams(max_new=5))
    st = eng.stats
    assert all(r.finish_reason == "length" and len(r.tokens) == 5
               and all(0 <= t < cfg.vocab_size for t in r.tokens)
               for r in res)
    assert st["tick_syncs"] == st["decode_ticks"]
    forwards = st["prefill_forwards"] + st["decode_ticks"]
    layers, ticks = cfg.n_layers, st["decode_ticks"]
    if state == "uniform":
        want = (0, 0, (7 * layers + 1) * forwards, 0, layers * ticks, 0)
    else:
        want = (0, 0, 2 * layers * forwards, (5 * layers + 1) * forwards, 0,
                layers * ticks)
    assert tuple(fn.launches for fn in kernels) == want
    acts = eng.quant_report()["acts"]
    assert acts["covered"] == acts["total"] == 8
    assert acts["fallback_sites"] == []


@pytest.mark.parametrize("cell", ["uniform", "window", "int", "gemma2"])
def test_decode_tick_runs_one_synchronizing_operation(cuda, cell):
    """A full-batch decode tick runs exactly one synchronizing CUDA
    operation, its host transfer, as PyTorch's sync debug mode counts them:
    over a bf16 pool, under a binding window (the in-tick eviction must
    stay on the device), through the integer GEMMs and on gemma2's
    local/global layers."""
    cfg = get_smoke_config("gemma2-2b" if cell == "gemma2"
                           else "tinyllama-1.1b")
    params = _to(tfm.init_params(cfg, 0, device="cpu"), cuda)
    extra = {"window": {"attention_window": WindowSpec(16, 1)},
             "int": {"act_bits": 8}}.get(cell, {})
    eng = ServingEngine(cfg, params, slots=2, max_seq=128,
                        quant_state=make_uniform_quant_state(cfg, params),
                        **extra)
    for i in range(2):
        eng.submit(Request(rid=i, prompt=np.arange(1, 40 + i), max_new=8))
    eng.step()
    eng.step()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1
    assert eng.stats["tick_syncs"] == eng.stats["decode_ticks"] == 3


# (S, causal, window, sinks, softcap): ragged S over the FMA kernel's
# 64-query tiles; a window that skips whole key tiles, with sinks covering
# a tile in part; gemma2's softcap; no mask but the causal one; not causal
# at all; then S against the tensor-core kernel's 128-query tiles and its
# 64/128-key tiles: one query, one row short, exact, one row over, and 333
# (ragged in both) under a window with 5 sinks (a sink tile covered in
# part) and the softcap, causal and not
K7_CASES = [(77, True, None, 0, None), (200, True, 40, 6, None),
            (200, True, 64, 0, 50.0), (130, False, None, 0, None),
            (1, True, None, 0, None), (127, True, None, 0, None),
            (128, True, None, 0, 50.0), (129, False, None, 0, None),
            (333, True, 64, 5, 50.0), (333, False, None, 0, 50.0)]


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", K7_CASES)
def test_flash_attention_kernel_matches_plain(cuda, hd, dtype, case, heads):
    """K7 on the model's (B, S, H, hd) tensors read through (B, H, S, hd)
    strides, two batch rows, GQA ratios 1, 2 and 8, against the plain
    version on the same inputs; its output is laid out (B, S, H, hd)
    transposed. bf16 at hd 64, 128 and 256 runs the tensor-core kernel,
    the rest the FMA kernel (``kernel_for``)."""
    s, causal, window, sinks, cap = case
    hq, hkv = heads
    g = torch.Generator(device=cuda).manual_seed(s + hd + hq * hkv)
    q, k, v = (torch.randn((2, s, h, hd), generator=g, device=cuda)
               .to(dtype).transpose(1, 2) for h in (hq, hkv, hkv))
    assert kernel_for(dtype, hd) == ("tensor-core" if dtype == torch.bfloat16
                                     and hd >= 64 else "fma")
    flash_attention.launches = 0
    got = flash_attention(q, k, v, causal=causal, window=window,
                          sinks=sinks, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == 1
    assert got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                              sinks=sinks, softcap=cap)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= k7_tolerance(ref, v)).all()), float(err.max())


def test_flash_attention_tensor_cores_reject_unaligned_operands(cuda):
    """The tensor-core kernel's TMA maps need (batch, head, position)
    strides that are multiples of 16 bytes and a 16-byte aligned base: a
    (B, S, H, 65) bf16 tensor cut to hd 64, or one shifted by an element,
    raises ValueError before any launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    wide = torch.randn((1, 40, 2, 65), generator=g, device=cuda).to(
        torch.bfloat16)
    flat = torch.randn((1 * 40 * 2 * 64 + 1,), generator=g,
                       device=cuda).to(torch.bfloat16)
    odd_stride = wide[..., :64].transpose(1, 2)
    odd_base = flat[1:].view(1, 40, 2, 64).transpose(1, 2)
    flash_attention.launches = 0
    for q in (odd_stride, odd_base):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention(q, q, q)
    assert flash_attention.launches == 0


def test_gemma2_engine_on_card_runs_through_k7(cuda):
    """Smoke gemma2 (local/global layers, softcaps) served on the card:
    every prefill's attention is K7, n_layers launches a prefill and none
    in a decode tick; decode goes through K2c on local layers and K2a on
    global ones; every GEMM through K1."""
    cfg = get_smoke_config("gemma2-2b")
    params = _to(tfm.init_params(cfg, 0, device="cpu"), cuda)
    eng = ServingEngine(cfg, params, slots=3, max_seq=64,
                        quant_state=make_uniform_quant_state(cfg, params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (3, 9, 20, 7)]
    kernels = (quant_matmul, flash_attention, paged_attention,
               paged_attention_window, fake_quant)
    for fn in kernels:
        fn.launches = 0
    reqs = [eng.submit(Request(rid=i, prompt=p, max_new=6))
            for i, p in enumerate(prompts)]
    while not all(r.done for r in reqs):
        before = (flash_attention.launches, eng.stats["prefill_forwards"])
        eng.step()
        assert flash_attention.launches - before[0] == cfg.n_layers * (
            eng.stats["prefill_forwards"] - before[1])
    st = eng.stats
    assert all(len(r.output) == 6 and all(0 <= t < cfg.vocab_size
                                          for t in r.output) for r in reqs)
    assert st["tick_syncs"] == st["decode_ticks"]
    half = cfg.n_layers // 2
    forwards = st["prefill_forwards"] + st["decode_ticks"]
    assert tuple(fn.launches for fn in kernels) == (
        (7 * cfg.n_layers + 1) * forwards, cfg.n_layers * len(prompts),
        half * st["decode_ticks"], half * st["decode_ticks"], 0)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("mn", [(1, 1), (3, 101), (64, 257), (300, 2048),
                                (5, 3), (7, 5632)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("signed", [True, False])
def test_fake_quant_kernel_bit_equal_to_plain(cuda, mn, dtype, signed,
                                              offset):
    """K3 against its plain version bit for bit: per-channel gates over
    every level (and below the 0.5 clamp), then one scalar 8-bit and the
    training's 16-bit scalar gate; N of 1, 3, 257 and 5632, x also as a
    view whose base sits one element into its storage."""
    m, n = mn
    g = torch.Generator(device=cuda).manual_seed(m * n + signed)
    x = (torch.randn((m * n + 1,), generator=g, device=cuda) * 1.5).to(dtype)
    x = x[1:].view(m, n) if offset else x[:m * n].view(m, n)
    levels = torch.tensor([0.3, 0.8, 1.5, 2.5, 3.05, 3.5, 5.5], device=cuda)
    gate = levels[torch.arange(n, device=cuda) % len(levels)]
    beta = torch.rand((n,), generator=g, device=cuda) * 1.7 + 0.3
    before = fake_quant.launches
    for gt in (gate, torch.full_like(gate, 2.5), torch.full_like(gate, 3.05)):
        got = fake_quant(x, gt, beta, signed)
        want = fake_quant_ref(x, gt, beta, signed)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)
    assert fake_quant.launches == before + 3


# the tolerances of tests/test_torch_train.py
LOSS_RTOL, GRAD_RTOL = 1e-3, 2e-2


@pytest.mark.parametrize("which", ["init", "mixed_weights"])
def test_train_steps_on_card_match_cpu(cuda, which):
    """Two CGMQ steps of the smoke config on the card (K3) and on the CPU
    (plain versions) from the same state: at init gates (32-bit, K3 passes
    through) and with the weight gates cycled over 2/4/8/16 bits. The first
    step's loss and gradients within test_torch_train.py's tolerances;
    Sat, BOP and the gates' bit-widths equal after each step; K3 launched
    once per weight site and per quantized activation per forward."""
    cfg = get_smoke_config("tinyllama-1.1b")
    recipe = train_steps.make_recipe(
        cfg, ShapeConfig("train", 16, 2, "train"), check_every=1)
    cpu = train_steps.init_train_state(recipe, 0, device="cpu")
    if which == "mixed_weights":
        levels = (0.8, 1.5, 2.5, 3.5)
        gates = {k: torch.full_like(v, levels[i % 4]) if k.endswith(".w")
                 else v for i, (k, v) in enumerate(sorted(
                     cpu.cgmq.gates.items()))}
        cpu.cgmq = init_state(gates, recipe.sites)
    card = bridge.train_state_from_numpy(bridge.tree_to_numpy(cpu),
                                         device=cuda)
    data = torch.from_numpy(lm_tokens(4, 16, cfg.vocab_size, seed=0,
                                      noise=0.05))
    batches = [{"tokens": data[i:i + 2, :-1], "targets": data[i:i + 2, 1:]}
               for i in (0, 2)]
    per_forward = 7 * cfg.n_layers + 1 + 3 * cfg.n_layers
    fake_quant.launches = 0
    lc, (gc, _, _), _, _ = train_steps.loss_and_grads(recipe, cpu,
                                                      batches[0])
    lg, (gg, _, _), _, _ = train_steps.loss_and_grads(
        recipe, card, {k: v.to(cuda) for k, v in batches[0].items()})
    assert fake_quant.launches == per_forward
    assert abs(float(lg) - float(lc)) <= LOSS_RTOL * abs(float(lc))
    for a, b in zip(tree_leaves(gc), tree_leaves(gg)):
        assert float((b.cpu() - a).norm()) <= GRAD_RTOL * float(a.norm())
    step = train_steps.make_train_step(recipe)
    for batch in batches:
        cpu, mc = step(cpu, batch)
        card, mg = step(card, {k: v.to(cuda) for k, v in batch.items()})
        assert bool(mc["sat"]) == bool(mg["sat"])
        assert float(mc["bop"]) == float(mg["bop"])
        assert np.isfinite(float(mg["loss"]))
        for k, v in cpu.cgmq.gates.items():
            assert torch.equal(gate_to_bits(card.cgmq.gates[k]).cpu(),
                               gate_to_bits(v))
    assert fake_quant.launches == 3 * per_forward


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
