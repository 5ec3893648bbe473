"""The port's fully-integer serving slice against repro (DESIGN.md §16).

Same inputs, made from a seed with numpy, go through ``repro`` (JAX on the
CPU; its Pallas kernels in interpret mode) and ``repro_torch``
(``device="cpu"``, where the K5/K6 wrappers take their plain versions):

* the integer GEMMs' plain versions and their ops (activation codes, the
  folded epilogue vectors, outputs), also on the serving route that folds
  the constants once (``int_gemm_plan``);
* the ``.in`` sites: gate, range and probe keys, calibrate-mode statistics,
  the train-mode forward and gradient, and the BOP certificate;
* ``make_act_specs``, ``export_act_sites`` and ``quant_report``;
* ``ServingEngine(act_bits=8)``: greedy tokens equal to repro's eager model
  functions on the same activation specs, decode logits near the port's
  own float-activation path.

Each test states its tolerance and why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.configs import get_smoke_config as j_smoke
from repro.core import bop as jbop
from repro.core import calibration as jcal
from repro.core.quantizer import quantize_to_int as j_quantize_to_int
from repro.core.sites import QuantConfig as JQuantConfig
from repro.core.sites import QuantContext as JQuantContext
from repro.core.sites import collect_sites as j_collect_sites
from repro.core.sites import init_gates as j_init_gates
from repro.core.sites import init_probes as j_init_probes
from repro.core.sites import \
    init_ranges_from_weights as j_init_ranges_from_weights
from repro.kernels.quant_matmul.ops import \
    int_matmul_op as j_int_matmul_op
from repro.kernels.quant_matmul.ops import \
    int_matmul_packed_op as j_int_matmul_packed_op
from repro.kernels.quant_matmul.ops import quant_matmul_qt as j_qm_qt
from repro.kernels.quant_matmul.quant_matmul import (int_matmul_packed_pallas,
                                                     int_matmul_pallas)
from repro.kernels.quant_matmul.ref import \
    int_matmul_packed_ref as j_int_matmul_packed_ref
from repro.kernels.quant_matmul.ref import int_matmul_ref as j_int_matmul_ref
from repro.models import transformer as jtfm
from repro.quant import ActQuantSpec as JActQuantSpec
from repro.quant import QuantizedTensor as JQuantizedTensor
from repro.quant.kv import KVQuantSpec as JKVQuantSpec
from repro.quant.export import export_act_sites as j_export_act_sites
from repro.quant.pack import pack_codes as j_pack_codes
from repro.quant.spec import specs_from_state as j_specs_from_state
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kv_pool as jkv
from repro.serving import make_act_specs as j_make_act_specs
from repro.serving import make_uniform_quant_state as j_uniform_state
from repro.serving.engine import export_int_model as j_export_int_model
from repro.serving.engine import make_mixed_quant_state as j_mixed_state
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import bop as tbop
from repro_torch.core import calibration as tcal
from repro_torch.core.quantizer import quantize_to_int
from repro_torch.core.sites import (QuantConfig, QuantContext, init_gates,
                                    init_probes, init_ranges_from_weights)
from repro_torch.kernels.quant_matmul.ops import (int_gemm, int_gemm_plan,
                                                  int_matmul_op,
                                                  int_matmul_packed_op,
                                                  quant_matmul_qt)
from repro_torch.kernels.quant_matmul.quant_matmul import (int_matmul,
                                                           int_matmul_packed)
from repro_torch.kernels.quant_matmul.ref import (int_accumulate,
                                                  int_matmul_packed_ref,
                                                  int_matmul_ref)
from repro_torch.models import transformer as ttfm
from repro_torch.quant import ActQuantSpec, QuantizedTensor
from repro_torch.quant.export import export_act_sites
from repro_torch.quant.pack import pack_codes
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_pool
from repro_torch.serving.engine import (ACT_GATE_LEVELS, SamplingParams,
                                        ServingEngine, make_act_specs)

ARCH = "tinyllama-1.1b"
# repro's own bound on the integer path's decode logits against the
# int-weight x float-activation path (tests/test_int_gemm.py): the
# requantization error of every GEMM input, about 1e-2 of the logits on
# random smoke weights.
DECODE_ATOL = 0.1
# One bf16 step (8 significant bits) is at most 2^-7 of a value.
BF16_STEP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bits_eq(a, b):
    """Bit-equality of two fp32 arrays (NaN-free here)."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and (a.view(np.int32) == b.view(np.int32)).all()


@pytest.fixture(scope="module")
def smoke():
    cfg = j_smoke(ARCH)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, params, get_smoke_config(ARCH), tparams


def _bridge_state(qs):
    return bridge.quant_state_from_numpy(
        jax.tree.map(np.asarray, qs["gates"]),
        jax.tree.map(np.asarray, qs["betas"]), qs["signed"],
        dataclasses.asdict(qs["qcfg"]), device="cpu")


@pytest.fixture(scope="module")
def states(smoke):
    """repro's uniform int8 and mixed 2/4/8-bit states, and the port's."""
    cfg, params = smoke[:2]
    out = {}
    for name, make in (("uniform", j_uniform_state), ("mixed",
                                                      j_mixed_state)):
        qs = make(cfg, params)
        out[name] = (qs, _bridge_state(qs))
    return out


@pytest.fixture(scope="module")
def act8(smoke):
    """repro's 8-bit ``.in`` specs of the smoke model, and their bridge."""
    cfg, params = smoke[:2]
    act = j_make_act_specs(cfg, params, 8)
    return act, bridge.act_specs_from_numpy(jax.tree.map(np.asarray, act),
                                            device="cpu")


# ---------------------------------------------------------------------------
# K5 / K6 plain versions: the int32 accumulator and the epilogue
# ---------------------------------------------------------------------------


def _int_inputs(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    half = 1 << (bits - 1)
    qx = rng.integers(-128, 128, (m, k)).astype(np.int8)
    codes = rng.integers(-half, half, (k, n)).astype(np.int8)
    eff_scale = rng.uniform(1e-5, 1e-3, n).astype(np.float32)
    eff_bias = rng.uniform(-1e-4, 1e-4, n).astype(np.float32)
    const = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    rowsum = qx.astype(np.int32).sum(1).astype(np.float32)
    return qx, codes, eff_scale, eff_bias, rowsum, const


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("mkn", [(3, 101, 37), (8, 64, 96), (13, 600, 40)])
def test_int_matmul_plain_bit_equal_to_repro(mkn, bits):
    """K5 (8-bit codes) and K6 (2/4-bit codes packed along K, odd K 101
    and a ragged K tail under Pallas' 512-wide K block at 600): the plain
    version's int32 accumulator equals the exact product (int64 numpy), its
    output is bit-equal to repro's ``int_matmul_ref``, and, with the
    epilogue the identity, to repro's Pallas kernel in interpret mode. With
    a real epilogue the Pallas kernel is held to one fp32 rounding of each
    of its three terms, 2^-23 of their magnitudes (XLA may contract its
    ``acc * s + r * b`` into an FMA); the port's plain version and repro's
    oracle round each product and sum once, in one order."""
    m, k, n = mkn
    qx, codes, es, eb, rs, cst = _int_inputs(m, k, n, bits, sum(mkn) + bits)
    acc = int_accumulate(_t(qx), _t(codes))
    assert acc.dtype == torch.int32
    assert (acc.numpy() == qx.astype(np.int64) @ codes.astype(np.int64)).all()
    t = [_t(a) for a in (es, eb, rs, cst)]
    if bits == 8:
        got = int_matmul_ref(_t(qx), _t(codes), *t)
        wrapped = int_matmul(_t(qx), _t(codes), *t)
        want = j_int_matmul_ref(jnp.asarray(qx), jnp.asarray(codes),
                                *map(jnp.asarray, (es, eb, rs, cst)))

        def pallas(*v):
            return int_matmul_pallas(jnp.asarray(qx), jnp.asarray(codes),
                                     *map(jnp.asarray, v), interpret=True)
    else:
        packed = pack_codes(_t(codes), bits)
        jpacked = j_pack_codes(jnp.asarray(codes), bits)
        assert (packed.numpy() == np.asarray(jpacked)).all()
        got = int_matmul_packed_ref(_t(qx), packed, *t, bits=bits, k=k)
        wrapped = int_matmul_packed(_t(qx), packed, *t, bits=bits, k=k)
        want = j_int_matmul_packed_ref(jnp.asarray(qx), jpacked,
                                       *map(jnp.asarray, (es, eb, rs, cst)),
                                       bits=bits, k=k)
        # K6's plain version is K5's on the unpacked codes, bit for bit
        assert _bits_eq(got, int_matmul_ref(_t(qx), _t(codes), *t))

        def pallas(*v):
            return int_matmul_packed_pallas(
                jnp.asarray(qx), jpacked, *map(jnp.asarray, v), bits=bits,
                k=k, interpret=True)
    assert _bits_eq(got, want) and _bits_eq(wrapped, got)
    ident = (np.ones(n, np.float32), np.zeros(n, np.float32), rs,
             np.zeros(n, np.float32))
    assert _bits_eq(pallas(*ident), acc.numpy().astype(np.float32))
    terms = (np.abs(acc.numpy().astype(np.float64) * es)
             + np.abs(rs[:, None] * eb) + np.abs(cst))
    diff = np.abs(np.asarray(pallas(es, eb, rs, cst), np.float64)
                  - got.numpy())
    assert (diff <= 2.0 ** -23 * terms * 3).all()


def _site(bits, seed, k=48, n=40):
    """One layer of a stacked per-channel export at ``bits`` (stored 8-bit,
    or packed at 2/4 bits), in both packages."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(2, k, n)).astype(np.float32) * 0.2
    wbits = np.full((2, 1, n), float(bits), np.float32)
    beta = rng.uniform(0.2, 0.6, size=(2, 1, 1)).astype(np.float32)
    jqt = JQuantizedTensor.from_float(jnp.asarray(w), jnp.asarray(wbits),
                                      jnp.asarray(beta), True,
                                      storage_bits=bits)
    tqt = QuantizedTensor.from_float(_t(w), _t(wbits), _t(beta), True,
                                     storage_bits=bits)
    return jax.tree.map(lambda a: a[1], jqt), tqt.layer(1)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("act_bits", [8, 4, 2])
@pytest.mark.parametrize("storage", [8, 4, 2])
def test_int_matmul_ops_equal_repro(storage, act_bits, signed):
    """``int_matmul_op``/``int_matmul_packed_op`` and ``quant_matmul_qt(
    act_spec=...)`` on 3-D bf16-valued activations. The activation codes
    and grid are repro's bit for bit; the outputs are bit-equal to repro's
    ops evaluated op by op (``jax.disable_jit``: the same fp32 operations in
    the same order on the same codes). Jitted, XLA contracts a product and
    a sum of repro's epilogue into an FMA, which moves an output by at most
    one fp32 rounding of its terms: held to 2^-22 of the sum of the three
    terms' magnitudes. The serving route that folds the constants once
    (``int_gemm_plan`` / ``int_gemm``) gives the per-call route's bits."""
    jqt, tqt = _site(storage, 11 * storage + act_bits)
    rng = np.random.default_rng(act_bits + 3 * signed)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 5, 48)) * 1.5,
                               jnp.bfloat16).astype(jnp.float32))
    beta = np.float32(2.0)
    jq, jsx, jbx = j_quantize_to_int(jnp.asarray(x.reshape(-1, 48)), act_bits,
                                     jnp.asarray(beta), signed)
    tq, tsx, tbx = quantize_to_int(_t(x.reshape(-1, 48)), act_bits,
                                   _t(beta), signed)
    assert (tq.numpy() == np.asarray(jq)).all()
    assert _bits_eq(tsx, jsx) and _bits_eq(tbx, jbx)
    jspec = JActQuantSpec(act_bits, jnp.asarray(beta), signed)
    with jax.disable_jit():
        want = np.asarray(j_qm_qt(jnp.asarray(x), jqt, act_spec=jspec,
                                  use_pallas=False))
    jitted = np.asarray(j_qm_qt(jnp.asarray(x), jqt, act_spec=jspec,
                                use_pallas=False))
    spec = ActQuantSpec(act_bits, _t(beta), signed)
    got = quant_matmul_qt(_t(x), tqt, act_spec=spec)
    assert _bits_eq(got, want)
    plan = int_gemm_plan(tqt, spec)
    assert plan.storage_bits == storage and plan.act_bits == act_bits
    assert _bits_eq(int_gemm(_t(x).to(torch.bfloat16), plan), got)
    acc = int_accumulate(tq, tqt.int8_codes()).numpy().astype(np.float64)
    rowsum = tq.numpy().astype(np.float64).sum(1)
    terms = (np.abs(acc * plan.eff_scale.numpy())
             + np.abs(rowsum[:, None] * plan.eff_bias.numpy())
             + np.abs(plan.const.numpy())).reshape(got.shape)
    assert (np.abs(jitted - got.numpy()) <= 2.0 ** -22 * terms).all()
    # the ops directly, as repro's ops take them
    n = 40
    vec = [t.reshape(-1).broadcast_to((n,)).contiguous()
           for t in (tqt.scale, tqt.bias, tqt.code_colsum())]
    jvec = [jnp.broadcast_to(a.reshape(-1), (n,))
            for a in (jqt.scale, jqt.bias, jqt.code_colsum())]
    if storage == 8:
        g2 = int_matmul_op(_t(x), tqt.codes, *vec, _t(beta),
                           act_bits=act_bits, act_signed=signed)
        with jax.disable_jit():
            w2 = j_int_matmul_op(jnp.asarray(x), jqt.codes, *jvec,
                                 jnp.asarray(beta), act_bits=act_bits,
                                 act_signed=signed, use_pallas=False)
    else:
        g2 = int_matmul_packed_op(_t(x), tqt.codes, *vec, _t(beta),
                                  bits=storage, k=48, act_bits=act_bits,
                                  act_signed=signed)
        with jax.disable_jit():
            w2 = j_int_matmul_packed_op(jnp.asarray(x), jqt.codes, *jvec,
                                        jnp.asarray(beta), bits=storage,
                                        k=48, act_bits=act_bits,
                                        act_signed=signed, use_pallas=False)
    assert _bits_eq(g2, w2) and _bits_eq(g2, got)


def test_int_matmul_wrappers_count_no_cpu_launch():
    """On CPU tensors the wrappers take the plain versions: no launch."""
    before = (int_matmul.launches, int_matmul_packed.launches)
    qx, codes, es, eb, rs, cst = _int_inputs(4, 16, 8, 4, 0)
    t = [_t(a) for a in (es, eb, rs, cst)]
    int_matmul(_t(qx), _t(codes), *t)
    int_matmul_packed(_t(qx), pack_codes(_t(codes), 4), *t, bits=4, k=16)
    assert (int_matmul.launches, int_matmul_packed.launches) == before
    with pytest.raises(ValueError, match="2 or 4 bits"):
        int_matmul_packed(_t(qx), _t(codes), *t, bits=8, k=16)


# ---------------------------------------------------------------------------
# ``.in`` sites
# ---------------------------------------------------------------------------


def _j_sites(cfg, params, qcfg):
    return j_collect_sites(
        lambda qc, x: jtfm.forward_train(qc, params, x, cfg),
        jnp.zeros((1, 8), jnp.int32), cfg=qcfg)


def test_in_site_state_matches_repro(smoke):
    """``QuantConfig(quantize_inputs=True)``: the port's gates, probes and
    ranges have repro's keys, in repro's order, with repro's shapes and
    values (per-tensor ``.in`` entries, stacked for scanned layers, none for
    the unquantized head); the default config makes none."""
    cfg, params, tcfg, _ = smoke
    jcfg, tcfg_q = JQuantConfig(quantize_inputs=True), \
        QuantConfig(quantize_inputs=True)
    jsites = _j_sites(cfg, params, jcfg)
    tsites = ttfm.collect_sites(tcfg)
    jg = j_init_gates(jsites, jcfg)
    tg = init_gates(tsites, tcfg_q, 5.5, "cpu")
    jp, tp = j_init_probes(jsites, jcfg), init_probes(tsites, tcfg_q, "cpu")
    jr = j_init_ranges_from_weights(jsites, jcfg, lambda n: None)
    tr = init_ranges_from_weights(tsites, tcfg_q, lambda n: None, "cpu")
    for j, t in ((jg, tg), (jp, tp)):
        assert list(t) == list(j)
        for k in j:
            assert tuple(t[k].shape) == j[k].shape
            assert (t[k].numpy() == np.asarray(j[k])).all()
    assert list(tr) == list(jr)
    for k in jr:
        assert tuple(tr[k]["beta"].shape) == jr[k]["beta"].shape
        assert tr[k]["signed"] == jr[k]["signed"]
    in_keys = [k for k in tg if k.endswith(".in")]
    assert len(in_keys) == 7 and "head.in" not in tg
    assert all(tuple(tg[k].shape) == (cfg.pattern_repeats,) for k in in_keys)
    assert not any(k.endswith(".in") for k in init_gates(
        tsites, QuantConfig(), 5.5, "cpu"))


def test_in_site_calibration_matches_repro(smoke):
    """Calibrate-mode ``.in`` statistics over two batches: the running
    per-tensor maxima (repro's keys, the head's input included) within one
    bf16 step of the larger batch max (test_torch_core.py's bound for a
    per-tensor max of bf16 activations summed in another order), signs
    equal."""
    cfg, params, tcfg, tparams = smoke
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, cfg.vocab_size, (2, 12)) for _ in range(2)]
    jcfg = JQuantConfig(quantize_inputs=True)

    def run(bs):
        return jcal.calibrate_activations(
            lambda qc, b: jtfm.forward_train(qc, params, b, cfg),
            [jnp.asarray(b) for b in bs], jcfg)

    want = run(batches)
    single = [run([b]) for b in batches]
    got = tcal.calibrate_activations(
        lambda qc, b: ttfm.forward_train(qc, tparams, b, tcfg),
        [_t(b) for b in batches], QuantConfig(quantize_inputs=True))
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".in") for k in got) == 8
    for k, v in want.items():
        assert got[k]["signed"] == v["signed"]
        a, b = np.asarray(v["beta"]), got[k]["beta"].numpy()
        peak = np.maximum(*(np.asarray(s1[k]["beta"]) for s1 in single))
        assert a.shape == b.shape
        assert (np.abs(b - a) <= BF16_STEP * peak).all(), k


@pytest.mark.parametrize("gate", [5.5, 2.5, 1.5])
@pytest.mark.parametrize("signed", [True, False])
def test_act_in_train_forward_and_gradient_match_repro(gate, signed):
    """A train-mode ``.in`` site on bf16 activations: 32 bits at the init
    gate (the straight-through pass), 8 and 4 bits below it. The forward
    is bit-equal (the same grid arithmetic in the same order); the
    gradients of x (the STE mask) are equal, those of beta and the probe
    are bf16-valued sums taken in another order, held to one bf16 step of
    their terms' L1 mass; the ``mean_abs`` statistic to one bf16 step."""
    rng = np.random.default_rng(int(gate * 10) + signed)
    x = np.asarray(jnp.asarray(rng.normal(size=(2, 6, 32)) * 1.2,
                               jnp.bfloat16).astype(jnp.float32))
    ct = rng.normal(size=x.shape).astype(np.float32)
    beta = np.float32(1.7)
    key = "mlp_up.in"
    jcfg, tcfg = JQuantConfig(quantize_inputs=True), \
        QuantConfig(quantize_inputs=True)

    def jfwd(xx, b, p):
        qc = JQuantContext("train", cfg=jcfg, gates={key: jnp.float32(gate)},
                           ranges={key: {"beta": b, "signed": signed}},
                           probes={key: p})
        y = qc.act_in("mlp_up", xx.astype(jnp.bfloat16))
        return jnp.sum(y.astype(jnp.float32) * ct), (y, qc.act_stats[key])

    (_, (jy, jst)), jgr = jax.value_and_grad(jfwd, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(x), jnp.float32(beta), jnp.float32(0.0))
    tx = _t(x).requires_grad_(True)
    tb = torch.tensor(beta, requires_grad=True)
    tp = torch.tensor(0.0, requires_grad=True)
    qc = QuantContext("train", cfg=tcfg, gates={key: torch.tensor(gate)},
                      ranges={key: {"beta": tb, "signed": signed}},
                      probes={key: tp})
    ty = qc.act_in("mlp_up", tx.to(torch.bfloat16))
    (ty.to(torch.float32) * _t(ct)).sum().backward()
    assert ty.dtype == torch.bfloat16
    assert _bits_eq(ty.detach().to(torch.float32), _np(jy))
    st = float(qc.act_stats[key]["mean_abs"].float())
    assert abs(st - float(_np(jst["mean_abs"]))) <= BF16_STEP * abs(st)
    assert (tx.grad.numpy() == _np(jgr[0])).all()
    mass = float(np.abs(ct).sum())
    for got, want in ((tb.grad, jgr[1]), (tp.grad, jgr[2])):
        assert abs(float(got) - float(want)) <= BF16_STEP * mass


@pytest.mark.parametrize("in_gate, rtol", [(5.5, 2e-2), (2.5, 4e-2)])
def test_train_forward_with_in_gates_matches_repro(smoke, in_gate, rtol):
    """A train-mode ``forward_train`` of the smoke model with its input
    sites at 32 (the init gate) or 8 bits, on ranges calibrated by repro,
    weights and outputs at the init gate. At 32 bits the logits are held
    to 2% of their max, the bound of the serving logits in
    test_torch_serving.py (bf16 roundings of sums taken in another order,
    carried through two layers). At 8 bits such a rounding can also flip
    an input code, which moves its element by a whole grid step (2 beta /
    255, larger than the bf16 step that flipped it): 2.1% measured, held
    to 4%. The site itself is bit-equal to repro's (the test above)."""
    cfg, params, tcfg, tparams = smoke
    jcfg, tcfg_q = JQuantConfig(quantize_inputs=True), \
        QuantConfig(quantize_inputs=True)
    jsites = _j_sites(cfg, params, jcfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 10))
    wts = {k[:-2]: w for k, w in ttfm.site_weights(tparams, tcfg).items()}
    jr = j_init_ranges_from_weights(
        jsites, jcfg, lambda n: jnp.asarray(wts[n].numpy()))
    act = jcal.calibrate_activations(
        lambda qc, b: jtfm.forward_train(qc, params, b, cfg),
        [jnp.asarray(toks)], jcfg)
    jr = jcal.apply_act_calibration(jr, act)
    jg = {k: (jnp.full_like(v, in_gate) if k.endswith(".in") else v)
          for k, v in j_init_gates(jsites, jcfg).items()}
    want = jtfm.forward_train(JQuantContext("train", cfg=jcfg, gates=jg,
                                            ranges=jr), params,
                              jnp.asarray(toks), cfg)
    tr = {k: {"beta": _t(v["beta"]), "signed": v["signed"]}
          for k, v in jr.items()}
    tg = {k: _t(v) for k, v in jg.items()}
    qc = QuantContext("train", cfg=tcfg_q, gates=tg, ranges=tr)
    got = ttfm.forward_train(qc, tparams, _t(toks), tcfg)
    want = np.asarray(want)[..., :cfg.vocab_size]
    got = got.detach().numpy()[..., :cfg.vocab_size]
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()
    assert sum(k.endswith(".in") for k in qc.act_stats) == 7


def test_bop_with_in_gates_equals_repro(smoke):
    """``model_bop`` resolves ``.in`` gates before ``.a`` ones as repro's
    does: equal at 8-bit inputs, and halved by 4-bit inputs."""
    cfg, params, tcfg, _ = smoke
    jcfg = JQuantConfig(quantize_inputs=True)
    jsites = _j_sites(cfg, params, jcfg)
    tsites = ttfm.collect_sites(tcfg)
    jg = j_init_gates(jsites, jcfg, init=2.5)
    bops = {}
    for lvl in (2.5, 1.5, 0.8):
        g = {k: (jnp.full_like(v, lvl) if k.endswith(".in") else v)
             for k, v in jg.items()}
        want = float(jbop.model_bop(jsites, g))
        bops[lvl] = float(tbop.model_bop(tsites,
                                         {k: _t(v) for k, v in g.items()}))
        assert bops[lvl] == pytest.approx(want, rel=1e-6)
    assert bops[1.5] == pytest.approx(bops[2.5] / 2.0, rel=1e-6)


# ---------------------------------------------------------------------------
# Activation specs, the export ledger and the report
# ---------------------------------------------------------------------------


def test_make_act_specs_matches_repro(smoke, act8):
    """The port's ``make_act_specs`` on repro's params: repro's keys, bits
    and signs, betas within one bf16 step of their value (a per-tensor max
    of bf16 activations, test_torch_core.py's calibration bound); the
    bridge carries repro's specs over exactly, and ``.layer`` slices them."""
    cfg, params, tcfg, tparams = smoke
    jact, bridged = act8
    got = make_act_specs(tcfg, tparams, 8)
    assert sorted(got) == sorted(jact) and len(got) == 8
    for k, js in jact.items():
        s = got[k]
        assert (s.bits, s.signed) == (js.bits, js.signed)
        want = np.asarray(js.beta)
        assert tuple(s.beta.shape) == want.shape
        assert (np.abs(s.beta.numpy() - want) <= BF16_STEP * want).all(), k
        assert (bridged[k].beta.numpy() == want).all()
        scale, bias = bridged[k].affine()
        jscale, jbias = js.affine()
        assert _bits_eq(scale, jscale) and _bits_eq(bias, jbias)
        assert _bits_eq(bridged[k].zero_point(), js.zero_point())
    q = bridged["p0_global/ffn/mlp_up.in"]
    assert q.layer(1).beta.numpy() == np.asarray(
        jact["p0_global/ffn/mlp_up.in"].beta)[1]
    assert make_act_specs(tcfg, tparams, 4)["head.in"].bits == 4


def test_export_act_sites_matches_repro(smoke, act8):
    """Every site gets an entry, as in repro: served "int" with its scale
    and zero-point where a spec exists; a quantized site without one is a
    "fake_quant" fallback with a UserWarning; an unquantized site without
    one is "excluded"."""
    cfg, params, tcfg, tparams = smoke
    jact, tact = act8
    jsites = _j_sites(cfg, params, JQuantConfig())
    sites = ttfm.collect_sites(tcfg)

    def same(got, want):
        assert list(got) == list(want)
        for k, w in want.items():
            g = got[k]
            assert (g.served, g.bits, g.reason) == (w.served, w.bits,
                                                    w.reason)
            if w.scale is not None:
                assert _bits_eq(g.scale, w.scale)
                assert _bits_eq(g.zero_point, w.zero_point)

    same(export_act_sites(tact, sites), j_export_act_sites(jact, jsites))
    victim = "p0_global/attn/attn_v.in"
    with pytest.warns(UserWarning, match="float GEMM inputs"):
        got = export_act_sites({k: v for k, v in tact.items()
                                if k != victim}, sites)
    with pytest.warns(UserWarning, match="float GEMM inputs"):
        want = j_export_act_sites({k: v for k, v in jact.items()
                                   if k != victim}, jsites)
    same(got, want)
    assert got[victim].served == "fake_quant"
    got = export_act_sites({k: v for k, v in tact.items()
                            if k != "head.in"}, sites, warn=False)
    assert got["head.in"].served == "excluded"
    same(got, j_export_act_sites({k: v for k, v in jact.items()
                                  if k != "head.in"}, jsites,
                                 warn=False))


def _same_report(got, want):
    assert got["per_site"] == want["per_site"]
    assert got["totals"] == pytest.approx(want["totals"], rel=1e-12)
    assert got["acts"] == want["acts"]
    assert got["bops"] == pytest.approx(want["bops"], rel=1e-6)
    assert got["kv_cache"] == want["kv_cache"]


@pytest.mark.parametrize("act_bits", [8, 4])
@pytest.mark.parametrize("state", ["uniform", "mixed"])
def test_quant_report_matches_repro(smoke, states, state, act_bits,
                                    monkeypatch):
    """``ServingEngine(act_bits=...).quant_report()``: repro's per-site
    bytes, totals, activation coverage (8 of 8 inputs at ``act_bits``, no
    fallback), BOPs (float sums of the same gate levels, to 1e-6) and KV
    section. The uniform state at 8-bit inputs certifies exactly the
    uniform-int8 BOPs, at 4-bit inputs half of them; the mixed state
    below them. The engines take repro's activation specs (the bridge), so
    the ledgers' grids are repro's too."""
    cfg, params, tcfg, tparams = smoke
    jqs, tqs = states[state]
    jeng = JServingEngine(cfg, params, slots=2, max_seq=32, quant_state=jqs,
                          act_bits=act_bits)
    tact = bridge.act_specs_from_numpy(jax.tree.map(np.asarray,
                                                    jeng.act_specs), "cpu")
    monkeypatch.setattr(tengine, "make_act_specs",
                        lambda *a, **kw: tact)
    eng = ServingEngine(tcfg, tparams, slots=2, max_seq=32, quant_state=tqs,
                        act_bits=act_bits, device="cpu")
    got, want = eng.quant_report(), jeng.quant_report()
    _same_report(got, want)
    acts, bops = got["acts"], got["bops"]
    assert acts["covered"] == acts["total"] == 8
    assert acts["fallback_sites"] == []
    assert set(acts["bits"].values()) == {act_bits}
    if state == "uniform":
        assert bops["model"] == pytest.approx(
            bops["uniform_int8"] * act_bits / 8, rel=1e-6)
    else:
        assert bops["model"] < bops["uniform_int8"] * act_bits / 8
    assert set(ACT_GATE_LEVELS) == {2, 4, 8}


def test_engine_act_bits_requires_quant_state(smoke):
    """As repro's: ``act_bits`` without a quant state is a ValueError."""
    tcfg, tparams = smoke[2:]
    with pytest.raises(ValueError, match="act_bits"):
        ServingEngine(tcfg, tparams, slots=2, max_seq=32, act_bits=8,
                      device="cpu")
    with pytest.raises(ValueError, match="act_bits"):
        ServingEngine(tcfg, tparams, slots=2, max_seq=32, act_bits=6,
                      device="cpu", quant_state=tengine.
                      make_uniform_quant_state(tcfg, tparams, device="cpu"))
    eng = ServingEngine(tcfg, tparams, slots=2, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="no quantized export"):
        eng.quant_report()


# ---------------------------------------------------------------------------
# Serving: greedy tokens and decode logits
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, (n,)) for n in (5, 8)]


def _repro_greedy_eager(cfg, params, qs, act, kv_spec, prompts, max_new):
    """repro's model functions with its act specs merged into the serve
    specs, called as its engine calls them: 2 slots, max_seq 64, 8-token
    blocks, one admission wave, then greedy ticks. ``prefill_slot`` and
    ``decode_step`` run op by op (``jax.disable_jit``): jitted, XLA
    contracts a product and a sum of the integer GEMM's epilogue into an
    FMA, an fp32 rounding that a bf16 cast downstream can turn into
    another token; op by op repro rounds each product and sum once, as the
    port does."""
    slots, bs, mb = len(prompts), 8, 8
    nb = slots * mb + 1
    qc = JQuantContext(mode="serve", cfg=qs["qcfg"],
                       qweights=j_export_int_model(params, cfg, qs)[0],
                       specs={**j_specs_from_state(qs["gates"], qs["betas"],
                                                   qs["signed"]), **act})
    cache = jtfm.init_paged_cache(cfg, slots, nb, bs, kv_spec=kv_spec)
    alloc = jkv.init_alloc(nb, slots, mb)
    out = []
    for slot, pr in enumerate(prompts):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(pr)] = pr
        alloc = jkv.alloc_range(alloc, slot, 0, -(-len(pr) // bs))
        with jax.disable_jit():
            logits, cache = jtfm.prefill_slot(
                qc, params, jnp.asarray(toks), len(pr), cache, slot, cfg,
                block_table=alloc["table"])
        out.append([int(np.asarray(logits[0, len(pr) - 1,
                                          :cfg.vocab_size]).argmax())])
    live = jnp.ones((slots,), bool)
    for _ in range(max_new - 1):
        alloc = jkv.tick_alloc(alloc, cache["pos"], live, bs)
        with jax.disable_jit():
            logits, cache = jtfm.decode_step(
                qc, params, cache,
                jnp.asarray([o[-1] for o in out], jnp.int32), cfg,
                advance=live, block_table=alloc["table"])
        for o, t in zip(out, np.asarray(logits[:, 0, :cfg.vocab_size])
                        .argmax(-1)):
            o.append(int(t))
    return out


@pytest.mark.parametrize("state, kv_dtype", [("uniform", "bf16"),
                                             ("mixed", "int4")])
def test_engine_act_bits_greedy_tokens_equal_repro(smoke, states, act8,
                                                   state, kv_dtype,
                                                   monkeypatch):
    """The quickstart workload through ``ServingEngine(act_bits=8)`` on
    repro's activation specs: the uniform int8 artifact over a bf16 pool
    and the mixed 2/4/8-bit one over an int4 pool give repro's eager
    greedy tokens, with one host sync per tick, every GEMM integer (K1/K4
    never take a CPU call either: their plain versions are not reached)
    and every block returned."""
    cfg, params, tcfg, tparams = smoke
    jqs, tqs = states[state]
    jact, tact = act8
    prompts = _prompts(cfg.vocab_size)
    kv_spec = None if kv_dtype == "bf16" else JKVQuantSpec(
        bits=4, group_size=16, head_dim=cfg.head_dim)
    want = _repro_greedy_eager(cfg, params, jqs, jact, kv_spec, prompts, 6)
    monkeypatch.setattr(tengine, "make_act_specs", lambda *a, **kw: tact)
    calls = []
    from repro_torch.kernels.quant_matmul import ops as tops
    monkeypatch.setattr(tops, "quant_matmul_op",
                        lambda *a, **kw: calls.append(a))
    monkeypatch.setattr(tops, "quant_matmul_packed_op",
                        lambda *a, **kw: calls.append(a))
    eng = ServingEngine(tcfg, tparams, slots=2, max_seq=64, quant_state=tqs,
                        kv_dtype=kv_dtype, act_bits=8, device="cpu")
    res = eng.generate(prompts, SamplingParams(max_new=6))
    assert [r.tokens for r in res] == want
    assert calls == []
    st = eng.stats
    assert st["tick_syncs"] == st["decode_ticks"] == 5
    assert int(eng.alloc["n_free"]) == eng.num_blocks - 1


def _decode_rows(tcfg, tparams, qc, steps=3):
    """The last prefill logits row and ``steps`` decode rows of one slot
    (repro's tests/test_int_gemm.py:_decode_rows, paged)."""
    bs, mb, plen = 8, 4, 8
    cache = ttfm.init_paged_cache(tcfg, 1, mb + 1, bs, device="cpu")
    alloc = kv_pool.init_alloc(mb + 1, 1, mb, device="cpu")
    alloc = kv_pool.alloc_range(alloc, 0, 0, 1)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (1, plen)))
    lg, cache = ttfm.prefill_slot(qc, tparams, x, plen, cache, 0, tcfg,
                                  block_table=alloc["table"])
    rows = [lg[0, plen - 1, :tcfg.vocab_size]]
    adv = torch.ones((1,), dtype=torch.int32)
    rng = np.random.default_rng(2)
    for _ in range(steps):
        tok = torch.tensor([int(rng.integers(0, tcfg.vocab_size))])
        alloc = kv_pool.tick_alloc(alloc, cache["pos"], adv, bs)
        lg, cache = ttfm.decode_step(qc, tparams, cache, tok, tcfg,
                                     advance=adv, block_table=alloc["table"])
        rows.append(lg[0, 0, :tcfg.vocab_size])
    return torch.stack(rows).numpy()


def test_int_decode_logits_near_float_activation_path(smoke, states):
    """The port's integer path against its own int-weight x float-
    activation path (K1 on the card): prefill and 3 decode rows within
    repro's DECODE_ATOL of 0.1 (requantization of every GEMM input, not
    accumulator error: the accumulator is exact)."""
    tcfg, tparams = smoke[2:]
    tqs = states["uniform"][1]
    from repro_torch.serving.engine import export_int_model
    qw, _ = export_int_model(tparams, tcfg, tqs, device="cpu")
    specs = tengine.specs_from_state(tqs["gates"], tqs["betas"],
                                     tqs["signed"])
    act = make_act_specs(tcfg, tparams, 8)
    got = _decode_rows(tcfg, tparams, QuantContext(
        "serve", cfg=tqs["qcfg"], qweights=qw, specs={**specs, **act}))
    want = _decode_rows(tcfg, tparams, QuantContext(
        "serve", cfg=tqs["qcfg"], qweights=qw, specs=specs))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=DECODE_ATOL)
