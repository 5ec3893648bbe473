"""The port's kernel entry points on the CPU against repro's.

On a CPU tensor each kernel wrapper takes its plain PyTorch version, so
these tests hold the plain versions (``quant_matmul_ref``,
``paged_attention_ref``) to ``repro``'s jnp oracles and to its Pallas
kernels run in interpret mode. The CUDA kernels themselves run only on the
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

from repro.kernels.paged_attention.ops import paged_attention_op as j_pa_op
from repro.kernels.quant_matmul.ops import quant_matmul_op as j_qm_op
from repro.kernels.quant_matmul.ops import quant_matmul_qt as j_qm_qt
from repro.quant.spec import QuantizedTensor as JQuantizedTensor
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import paged_attention_op
from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.quant_matmul.ops import (quant_matmul_op,
                                                  quant_matmul_qt)
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.quant.spec import QuantizedTensor

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
    """One layer of a stacked per-channel export, 3-D activations."""
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
    with pytest.raises(NotImplementedError, match="item 9"):
        quant_matmul_qt(torch.from_numpy(x), tqt.layer(1), act_spec=object())


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
