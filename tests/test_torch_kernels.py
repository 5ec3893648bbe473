"""The port's kernel entry points on the CPU against repro's.

On a CPU tensor each kernel wrapper takes its plain PyTorch version, so
these tests hold the plain versions (``quant_matmul_ref``,
``quant_matmul_packed_ref``, ``paged_attention_ref`` over float and
quantized pools) to ``repro``'s jnp oracles and to its Pallas kernels run
in interpret mode. The CUDA kernels themselves run only on the
card: ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold them to these
plain versions there.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.kernels.paged_attention.ops import paged_attention_op as j_pa_op
from repro.kernels.quant_matmul.ops import quant_matmul_op as j_qm_op
from repro.kernels.quant_matmul.ops import \
    quant_matmul_packed_op as j_qm_packed_op
from repro.kernels.quant_matmul.ops import quant_matmul_qt as j_qm_qt
from repro.core.quantizer import fake_quant as j_fake_quant
from repro.quant import kv as jkv
from repro.quant.pack import pack_codes as j_pack_codes
from repro.quant.spec import ActQuantSpec as JActQuantSpec
from repro.quant.spec import QuantizedTensor as JQuantizedTensor
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import paged_attention_op
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention, paged_attention_quant)
from repro_torch.kernels.paged_attention.ref import (
    bf16_rounding_tolerance, paged_attention_ref)
from repro_torch.kernels.quant_matmul.ops import (quant_matmul_op,
                                                  quant_matmul_packed_op,
                                                  quant_matmul_qt)
from repro_torch.kernels.quant_matmul.quant_matmul import (
    quant_matmul, quant_matmul_packed)
from repro_torch.kernels.quant_matmul.ref import (quant_matmul_packed_ref,
                                                  quant_matmul_ref)
from repro_torch.quant import kv as tkv
from repro_torch.quant.pack import pack_codes
from repro_torch.quant.spec import ActQuantSpec, QuantizedTensor

PKG = Path(__file__).resolve().parent.parent / "src" / "repro_torch"

# fp32 GEMM tolerance: both sides sum K fp32 products in different orders
# (XLA's dot or the Pallas K-block loop vs torch's CPU GEMM), and the
# Pallas kernel also reassociates into scale*(x@codes) + bias*rowsum(x).
# Random-sign rounding grows like sqrt(K)*eps32 of |x|@|w|; 1e-5 of it
# leaves a wide margin at K <= 600.
QM_RTOL = 1e-5
# bf16 attention tolerance: repro's oracle and the port's plain version
# round the softmax probabilities to bf16 before the PV product; the
# Pallas kernel keeps them fp32. A bf16 rounding moves a probability by at
# most 2^-9 of itself, so outputs move by at most 2^-9 * max|v| (and two
# bf16 roundings that land on either side of a tie by twice that).
PA_TOL_FACTOR = 2.0 ** -8


# fp32 against fp32: the same attention, sums and the softmax normalisation
# taken in another order (online rescaling vs one softmax); a few dozen
# fp32 ulps of max|v| at these lengths, so 1e-4 leaves a wide margin and a
# wrong scale group or nibble (errors of order max|v|) still fails.
PA_F32_RTOL = 1e-4


def _qm_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, size=(n,)).astype(np.float32)
    bias = rng.uniform(-1e-3, 1e-3, size=(n,)).astype(np.float32)
    return x, codes, scale, bias


def _qm_tol(x, codes, scale, bias):
    w = codes.astype(np.float32) * scale + bias
    return QM_RTOL * (np.abs(x) @ np.abs(w)) + 1e-7


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("mkn", [(8, 64, 96), (13, 600, 40), (3, 100, 37)])
def test_quant_matmul_plain_matches_repro(mkn, use_pallas):
    """(13, 600, 40) has a ragged K tail under Pallas' 512-wide K block."""
    x, codes, scale, bias = _qm_inputs(*mkn, seed=sum(mkn))
    want = np.asarray(j_qm_op(jnp.asarray(x), jnp.asarray(codes),
                              jnp.asarray(scale), jnp.asarray(bias),
                              use_pallas=use_pallas, interpret=True))
    got = quant_matmul_op(torch.from_numpy(x), torch.from_numpy(codes),
                          torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert (np.abs(got.numpy() - want) <= _qm_tol(x, codes, scale,
                                                  bias)).all()


def test_quant_matmul_qt_matches_repro():
    """One layer of a stacked per-channel export, 3-D activations; with an
    8-bit ``ActQuantSpec`` the integer GEMM (K5's plain version), bit-equal
    to repro's ``quant_matmul_qt(act_spec=...)`` evaluated op by op
    (jitted, XLA contracts a product and a sum of its epilogue into an FMA;
    tests/test_torch_int.py bounds that) and within the fused dequant
    GEMM's tolerance of the float-activation path on the fake-quantized
    input."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(2, 48, 40)).astype(np.float32) * 0.2
    bits = np.full((2, 1, 40), 8.0, np.float32)
    beta = rng.uniform(0.2, 0.6, size=(2, 1, 1)).astype(np.float32)
    jqt = JQuantizedTensor.from_float(jnp.asarray(w), jnp.asarray(bits),
                                      jnp.asarray(beta), True, storage_bits=8)
    tqt = QuantizedTensor.from_float(torch.from_numpy(w),
                                     torch.from_numpy(bits),
                                     torch.from_numpy(beta), True,
                                     storage_bits=8)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    want = np.asarray(j_qm_qt(jnp.asarray(x),
                              jax.tree.map(lambda a: a[1], jqt),
                              use_pallas=False))
    got = quant_matmul_qt(torch.from_numpy(x), tqt.layer(1)).numpy()
    tol = _qm_tol(x.reshape(-1, 48), np.asarray(jqt.codes[1]),
                  np.asarray(jqt.scale[1]).reshape(-1),
                  np.asarray(jqt.bias[1]).reshape(-1)).reshape(want.shape)
    assert (np.abs(got - want) <= tol).all()
    beta = np.float32(2.5)
    with jax.disable_jit():
        want_int = np.asarray(j_qm_qt(
            jnp.asarray(x), jax.tree.map(lambda a: a[1], jqt),
            act_spec=JActQuantSpec(8, jnp.asarray(beta)), use_pallas=False))
    got_int = quant_matmul_qt(torch.from_numpy(x), tqt.layer(1),
                              act_spec=ActQuantSpec(8, torch.tensor(beta)))
    assert got_int.dtype == torch.float32
    assert (got_int.numpy().view(np.int32) == want_int.view(np.int32)).all()
    xq = np.array(j_fake_quant(jnp.asarray(x), jnp.float32(8.0),
                               jnp.asarray(beta), True))
    assert (np.abs(got_int.numpy() - quant_matmul_qt(
        torch.from_numpy(xq), tqt.layer(1)).numpy())
        <= _qm_tol(xq.reshape(-1, 48), np.asarray(jqt.codes[1]),
                   np.asarray(jqt.scale[1]).reshape(-1),
                   np.asarray(jqt.bias[1]).reshape(-1)).reshape(
                       want.shape)).all()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("mkn", [(3, 101, 37), (8, 64, 96), (13, 600, 40)])
def test_quant_matmul_packed_plain_matches_repro(mkn, bits, use_pallas):
    """Odd and ragged K (101, and 600 under Pallas' 512-wide K block); the
    plain packed version is also bit-equal to the plain int8 path on the
    unpacked codes, as repro's packed oracle is."""
    m, k, n = mkn
    x, _, scale, bias = _qm_inputs(m, k, n, seed=sum(mkn) + bits)
    rng = np.random.default_rng(bits)
    codes = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                         (k, n)).astype(np.int8)
    jpacked = j_pack_codes(jnp.asarray(codes), bits)
    packed = pack_codes(torch.from_numpy(codes), bits)
    want = np.asarray(j_qm_packed_op(
        jnp.asarray(x), jpacked, jnp.asarray(scale), jnp.asarray(bias),
        bits=bits, k=k, use_pallas=use_pallas, interpret=True))
    t = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = quant_matmul_packed_op(t[0], packed, t[1], t[2], bits=bits, k=k)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert (np.abs(got.numpy() - want)
            <= _qm_tol(x, codes, scale, bias)).all()
    assert torch.equal(got, quant_matmul_op(t[0], torch.from_numpy(codes),
                                            t[1], t[2]))


def test_quant_matmul_qt_packed_matches_repro():
    """One layer of a stacked per-channel packed export: 2-bit and 4-bit
    sites go through the packed path, bit-equal to ``pack=False``."""
    rng = np.random.default_rng(8)
    w = rng.normal(size=(2, 45, 24)).astype(np.float32) * 0.2
    beta = rng.uniform(0.2, 0.6, size=(2, 1, 1)).astype(np.float32)
    x = rng.normal(size=(2, 5, 45)).astype(np.float32)
    for b in (2.0, 4.0):
        bits = np.full((2, 1, 24), b, np.float32)
        jqt = JQuantizedTensor.from_float(
            jnp.asarray(w), jnp.asarray(bits), jnp.asarray(beta), True,
            storage_bits=int(b))
        args = (torch.from_numpy(w), torch.from_numpy(bits),
                torch.from_numpy(beta), True)
        tqt = QuantizedTensor.from_float(*args, storage_bits=int(b))
        oracle = QuantizedTensor.from_float(*args, storage_bits=int(b),
                                            pack=False)
        assert tqt.packed and tqt.codes.dtype == torch.uint8
        assert tqt.layer(1).codes.is_contiguous()
        want = np.asarray(j_qm_qt(jnp.asarray(x),
                                  jax.tree.map(lambda a: a[1], jqt),
                                  use_pallas=False))
        got = quant_matmul_qt(torch.from_numpy(x), tqt.layer(1))
        tol = _qm_tol(x.reshape(-1, 45), np.asarray(jqt.int8_codes()[1]),
                      np.asarray(jqt.scale[1]).reshape(-1),
                      np.asarray(jqt.bias[1]).reshape(-1)).reshape(want.shape)
        assert (np.abs(got.numpy() - want) <= tol).all()
        assert torch.equal(got, quant_matmul_qt(torch.from_numpy(x),
                                                oracle.layer(1)))


def _pa_inputs(seed, b=3, kvh=2, g=2, hd=16, bs=4, mb=5, pool_dtype=np.float32):
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    pos = rng.integers(0, mb * bs, size=b).astype(np.int32)
    pos[0] = mb * bs - 1                      # one full row
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    table = np.full((b, mb), -1, np.int32)
    for i, p in enumerate(pos):
        # -1 entries only past pos: repro's oracle gathers a -1 entry from
        # the garbage block, the kernels skip it, and past pos both mask it
        n = p // bs + 1
        table[i, :n] = perm[i * mb:i * mb + n]
    q = rng.normal(size=(b, kvh, g, hd)).astype(np.float32)
    k = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    return q, k, v, table, pos


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_paged_attention_plain_matches_repro(use_pallas, softcap):
    q, k, v, table, pos = _pa_inputs(seed=11 if softcap else 12)
    bf = jnp.bfloat16
    want = np.asarray(j_pa_op(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        jnp.asarray(table), jnp.asarray(pos), softcap=softcap,
        use_pallas=use_pallas, interpret=True))
    tb = torch.bfloat16
    got = paged_attention_op(
        torch.from_numpy(q).to(tb), torch.from_numpy(k).to(tb),
        torch.from_numpy(v).to(tb), torch.from_numpy(table),
        torch.from_numpy(pos), softcap=softcap)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = PA_TOL_FACTOR * np.abs(v).max() + 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _pa_quant_pools(k, v, bits, hd):
    """Quantize float pools with both packages' codecs (bit-equal)."""
    jspec = jkv.KVQuantSpec(bits=bits, group_size=32, head_dim=hd)
    tspec = tkv.KVQuantSpec(bits=bits, group_size=32, head_dim=hd)
    jpools = [jkv.quantize_kv(jnp.asarray(a), jspec) for a in (k, v)]
    tpools = [tkv.quantize_kv(torch.from_numpy(a), tspec) for a in (k, v)]
    for (jc, js), (tc, ts) in zip(jpools, tpools):
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    deq = [tkv.dequantize_kv(c, sc, tspec).numpy() for c, sc in tpools]
    return jpools, tpools, deq


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_attention_quant_plain_matches_repro(bits, use_pallas):
    """int8 and int4 pools at head_dim 64 (two scale groups of 32); every
    -1 table entry lies past pos."""
    q, k, v, table, pos = _pa_inputs(seed=20 + bits, hd=64, mb=4)
    (jk, jv), (tk, tv), (kd, vd) = _pa_quant_pools(k, v, bits, 64)
    want = np.asarray(j_pa_op(
        jnp.asarray(q, jnp.bfloat16), jk[0], jv[0], jnp.asarray(table),
        jnp.asarray(pos), use_pallas=use_pallas, interpret=True,
        k_scale=jk[1], v_scale=jv[1]))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = paged_attention_op(tq, tk[0], tv[0], torch.from_numpy(table),
                             torch.from_numpy(pos), k_scale=tk[1],
                             v_scale=tv[1])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # against the oracle, which rounds where the plain version does, the
    # float pools' tolerance; against the fp32 Pallas kernel, the bound of
    # the plain version's bf16 roundings (bf16_rounding_tolerance)
    tol = bf16_rounding_tolerance(
        tq, torch.from_numpy(kd), torch.from_numpy(vd),
        torch.from_numpy(table), torch.from_numpy(pos)) \
        if use_pallas else PA_TOL_FACTOR * np.abs(vd).max() + 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    if use_pallas:
        # with q in fp32 the plain version rounds nothing to bf16: it is the
        # kernel's function, up to the order of fp32 sums
        f32 = paged_attention_op(tq.float(), tk[0], tv[0],
                                 torch.from_numpy(table),
                                 torch.from_numpy(pos), k_scale=tk[1],
                                 v_scale=tv[1])
        np.testing.assert_allclose(f32.numpy(), want, rtol=0,
                                   atol=PA_F32_RTOL * np.abs(vd).max())


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    x, codes, scale, bias = _qm_inputs(4, 32, 24, seed=1)
    t = [torch.from_numpy(a) for a in (x, codes, scale, bias)]
    q, k, v, table, pos = _pa_inputs(seed=2)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    pa_args = (tq, torch.from_numpy(k), torch.from_numpy(v),
               torch.from_numpy(table), torch.from_numpy(pos))
    n_qm, n_pa = quant_matmul.launches, paged_attention.launches
    got = quant_matmul(*t, t[0].sum(dim=1))
    assert torch.equal(got, quant_matmul_ref(*t))
    assert torch.equal(paged_attention(*pa_args), paged_attention_ref(*pa_args))
    assert (quant_matmul.launches, paged_attention.launches) == (n_qm, n_pa)


def test_k4_and_k2b_wrappers_take_plain_version_on_cpu():
    x, _, scale, bias = _qm_inputs(4, 33, 24, seed=3)
    codes = np.random.default_rng(3).integers(-8, 8, (33, 24)).astype(
        np.int8)
    t = [torch.from_numpy(a) for a in (x, scale, bias)]
    packed = pack_codes(torch.from_numpy(codes), 4)
    q, k, v, table, pos = _pa_inputs(seed=4, hd=64)
    _, (tk, tv), _ = _pa_quant_pools(k, v, 4, 64)
    pa_args = (torch.from_numpy(q).to(torch.bfloat16), tk[0], tv[0], tk[1],
               tv[1], torch.from_numpy(table), torch.from_numpy(pos))
    n_k4, n_k2b = quant_matmul_packed.launches, paged_attention_quant.launches
    got = quant_matmul_packed(t[0], packed, t[1], t[2], t[0].sum(dim=1),
                              bits=4, k=33)
    assert torch.equal(got, quant_matmul_packed_ref(t[0], packed, t[1], t[2],
                                                    bits=4, k=33))
    assert torch.equal(paged_attention_quant(*pa_args), paged_attention_ref(
        *pa_args[:3], *pa_args[5:], k_scale=pa_args[3], v_scale=pa_args[4]))
    assert (quant_matmul_packed.launches, paged_attention_quant.launches) \
        == (n_k4, n_k2b)
    with pytest.raises(ValueError, match="2 or 4 bits"):
        quant_matmul_packed(t[0], packed, t[1], t[2], t[0].sum(dim=1),
                            bits=8, k=33)
    meta = torch.empty((4, 33), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        quant_matmul_packed(meta, packed, t[1], t[2], t[0].sum(dim=1),
                            bits=4, k=33)


def test_wrappers_reject_other_devices():
    meta = torch.empty((4, 8), device="meta")
    codes = torch.empty((8, 3), dtype=torch.int8, device="meta")
    vec = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        quant_matmul(meta, codes, vec, vec, torch.empty((4,), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_attention(torch.empty((1, 1, 1, 8), dtype=torch.bfloat16,
                                    device="meta"), meta, meta, meta, meta)


def test_kernel_sources_build_targets_and_no_fallback():
    """Every csrc/*.cu is a build source with an sm_90a target and its own
    content-hashed library; no kernel module (``_build`` included) has a ``try``
    (so no failed build or launch can fall back to a plain version)."""
    assert sorted(p.stem for p in (PKG / "csrc").glob("*.cu")) \
        == sorted(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD and lib.name.startswith(
            f"lib{name}-")
    for path in [*(PKG / "kernels").rglob("*.py")]:
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path
