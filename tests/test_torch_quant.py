"""The port's quantizer, specs, quant states and export against repro.

Same inputs, made from a seed with numpy, go through ``repro`` (JAX, on the
CPU) and ``repro_torch`` (``device="cpu"``). Everything here is integer
codes or fp32 grid arithmetic done in the same order in both packages, so
the tolerance is zero: codes, scales, biases, bits, site keys and shapes
must be bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # container without hypothesis: deterministic replay
    from _hyp_fallback import given, settings
    from _hyp_fallback import strategies as st

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.configs import get_smoke_config as j_smoke
from repro.core import gates as jg
from repro.core import quantizer as jq
from repro.core.sites import QuantConfig as JQuantConfig
from repro.core.sites import QuantContext as JQuantContext
from repro.core.sites import collect_sites as j_collect_sites
from repro.models import transformer as jtfm
from repro.quant.spec import QuantSpec as JQuantSpec
from repro.quant.spec import specs_from_state as j_specs
from repro.serving.engine import export_int_model as j_export_int_model
from repro.serving.engine import MIXED_GATE_LEVELS as J_MIXED_GATE_LEVELS
from repro.serving.engine import \
    make_mixed_quant_state as j_make_mixed_quant_state
from repro.serving.engine import \
    make_uniform_quant_state as j_make_uniform_quant_state
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import gates as tg
from repro_torch.core import quantizer as tq
from repro_torch.core.sites import QuantConfig, QuantContext
from repro_torch.models import transformer as ttfm
from repro_torch.quant.spec import QuantSpec, specs_from_state
from repro_torch.serving.engine import (MIXED_GATE_LEVELS, export_int_model,
                                        make_mixed_quant_state,
                                        make_uniform_quant_state)

BITS = (2, 4, 8, 16, 32)
# a few examples each: first calls compile under JAX, so no deadline
PROP = settings(max_examples=6, deadline=None, database=None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(jax_out, torch_out):
    """Bit equality of a JAX array and a torch tensor (bf16 compared as
    fp32, which is exact)."""
    a = np.asarray(jnp.asarray(jax_out, jnp.float32)) \
        if jnp.asarray(jax_out).dtype == jnp.bfloat16 else np.asarray(jax_out)
    b = torch_out.to(torch.float32).numpy() \
        if torch_out.dtype == torch.bfloat16 else torch_out.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@PROP
@given(seed=st.integers(0, 2**16), bits=st.sampled_from(BITS),
       signed=st.booleans(), bf16=st.booleans())
def test_quantize_bit_equal(seed, bits, signed, bf16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(7, 33)).astype(np.float32) * 2.0
    beta = rng.uniform(0.2, 3.0, size=(33,)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)
    xt = _t(x).to(torch.bfloat16) if bf16 else _t(x)
    want = jq.quantize(xj, jnp.float32(bits), jnp.asarray(beta), signed)
    _eq(want, tq.quantize(xt, float(bits), _t(beta), signed))
    # per-channel bit-widths broadcast like per-channel ranges
    cb = rng.choice(np.asarray(BITS, np.float32), size=(33,))
    _eq(jq.quantize(xj, jnp.asarray(cb), jnp.asarray(beta), signed),
        tq.quantize(xt, _t(cb), _t(beta), signed))


@PROP
@given(seed=st.integers(0, 2**16), bits=st.sampled_from((2, 4, 8)),
       signed=st.booleans())
def test_quantize_to_int_and_affine_grid_bit_equal(seed, bits, signed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(3, 40, 24)).astype(np.float32) * 0.3
    beta = rng.uniform(0.1, 1.5, size=(3, 1, 1)).astype(np.float32)
    cb = np.full((3, 1, 24), float(bits), np.float32)
    jc, js, jb = jq.quantize_to_int(jnp.asarray(w), jnp.asarray(cb),
                                    jnp.asarray(beta), signed)
    tc, ts, tb = tq.quantize_to_int(_t(w), _t(cb), _t(beta), signed)
    assert tc.dtype == torch.int8 and jc.dtype == jnp.int8
    for a, b in ((jc, tc), (js, ts), (jb, tb)):
        _eq(a, b)
    gs, gb = jq.affine_grid(bits, jnp.asarray(beta), signed)
    hs, hb = tq.affine_grid(bits, _t(beta), signed)
    _eq(gs, hs)
    _eq(gb, hb)


def test_gates_transform_and_spec_bit_equal():
    g = np.asarray([-1.0, 0.0, 0.3, 0.5, 0.8, 1.0, 1.0001, 1.5, 2.0, 2.2,
                    2.5, 3.0, 3.5, 4.0, 4.0001, 5.5, 6.0], np.float32)
    _eq(jg.transform(jnp.asarray(g)), tg.transform(_t(g)))
    _eq(jg.gate_to_bits(jnp.asarray(g)), tg.gate_to_bits(_t(g)))
    beta = np.linspace(0.5, 2.0, g.size).astype(np.float32)
    for lo, hi in ((0, 3), (3, 7), (7, 9), (9, 12), (12, 17)):
        js = JQuantSpec.from_gate(jnp.asarray(g[lo:hi]),
                                  jnp.asarray(beta[lo:hi]), True)
        ts = QuantSpec.from_gate(_t(g[lo:hi]), _t(beta[lo:hi]), True)
        _eq(js.bits, ts.bits)
        _eq(js.beta, ts.beta)
        assert js.storage_bits() == ts.storage_bits()


@pytest.fixture(scope="module")
def smoke():
    """repro's smoke tinyllama params and uniform state, and the port's."""
    cfg = j_smoke("tinyllama-1.1b")
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    qs = j_make_uniform_quant_state(cfg, params)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, params, qs, get_smoke_config("tinyllama-1.1b"), tparams


def test_sites_and_uniform_quant_state_match_repro(smoke):
    cfg, params, qs, tcfg, tparams = smoke
    jsites = j_collect_sites(
        lambda qc, p, x: jtfm.forward_train(qc, p, x, cfg, remat=False),
        params, jnp.zeros((1, 8), jnp.int32),
        cfg=JQuantConfig(granularity="per_channel"))
    tsites = ttfm.collect_sites(tcfg)
    assert list(tsites) == list(jsites)
    for name, s in jsites.items():
        assert dataclasses.asdict(tsites[name]) == dataclasses.asdict(s)

    tqs = make_uniform_quant_state(tcfg, tparams, device="cpu")
    assert dataclasses.asdict(tqs["qcfg"]) == dataclasses.asdict(qs["qcfg"])
    for part in ("gates", "betas"):
        assert list(tqs[part]) == list(qs[part])
        for k, v in qs[part].items():
            _eq(v, tqs[part][k])
    assert tqs["signed"] == qs["signed"]
    # the shapes repro gives: per-channel (R, N) weight gates, per-tensor
    # (R,) weight betas, (R, N) activation gates, and the head's
    # (padded_vocab,) gate with a scalar beta
    r = cfg.pattern_repeats
    assert tuple(tqs["gates"]["p0_global/attn/attn_q.w"].shape) == (r, 64)
    assert tuple(tqs["betas"]["p0_global/attn/attn_q.w"].shape) == (r,)
    assert tuple(tqs["gates"]["p0_global/ffn/mlp_down.a"].shape) == (r, 64)
    assert tuple(tqs["gates"]["head.w"].shape) == (cfg.padded_vocab,)
    assert tuple(tqs["betas"]["head.w"].shape) == ()


def test_export_int_model_bit_equal(smoke):
    cfg, params, qs, tcfg, tparams = smoke
    # a non-uniform state: per-channel gates anywhere in the 8-bit band and
    # small ranges, so grid placement and the clip path are both exercised
    rng = np.random.default_rng(3)
    gates = {k: (rng.uniform(2.01, 3.0, np.shape(v)).astype(np.float32)
                 if k.endswith(".w") else np.asarray(v))
             for k, v in qs["gates"].items()}
    betas = {k: (rng.uniform(0.02, 0.2, np.shape(v)).astype(np.float32)
                 if k.endswith(".w") else np.asarray(v))
             for k, v in qs["betas"].items()}
    jstate = {**qs, "gates": {k: jnp.asarray(v) for k, v in gates.items()},
              "betas": {k: jnp.asarray(v) for k, v in betas.items()}}
    jqw, jledger = j_export_int_model(params, cfg, jstate)
    tstate = bridge.quant_state_from_numpy(
        gates, betas, qs["signed"], dataclasses.asdict(qs["qcfg"]),
        device="cpu")
    tqw, tledger = export_int_model(tparams, tcfg, tstate, device="cpu")
    assert sorted(tqw) == sorted(jqw)
    for k, jt in jqw.items():
        t = tqw[k]
        assert (t.storage_bits, t.k) == (jt.storage_bits, jt.k)
        for field in ("codes", "scale", "bias", "colsum"):
            _eq(getattr(jt, field), getattr(t, field))
        np.testing.assert_array_equal(np.asarray(jt.dequantize()),
                                      t.dequantize().numpy())
    assert tledger.entries == jledger.entries


def test_serve_mode_sites_bit_equal(smoke):
    """Serve-mode weight fallback, activation sites and the fixed 8-bit
    input quantizer land on repro's grid exactly."""
    cfg, params, qs, tcfg, tparams = smoke
    act = "p0_global/ffn/mlp_down.a"
    keys = {"x.a": (qs["gates"][act][0], qs["betas"][act][0]),
            "head.w": (qs["gates"]["head.w"], qs["betas"]["head.w"])}
    jqc = JQuantContext("serve", cfg=qs["qcfg"], specs=j_specs(
        {k: g for k, (g, _) in keys.items()},
        {k: b for k, (_, b) in keys.items()}, dict.fromkeys(keys, True)))
    tqc = QuantContext("serve", cfg=QuantConfig(granularity="per_channel"),
                       specs=specs_from_state(
                           {k: _t(g) for k, (g, _) in keys.items()},
                           {k: _t(b) for k, (_, b) in keys.items()},
                           dict.fromkeys(keys, True)))
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2, 5, 288)).astype(np.float32) * 3
    _eq(jqc.input(jnp.asarray(a, jnp.bfloat16)),
        tqc.input(_t(a).to(torch.bfloat16)))
    w = np.asarray(params["embed"]).T
    _eq(jqc.weight("head", jnp.asarray(w)), tqc.weight("head", _t(w)))
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    _eq(jqc.act("x", jnp.asarray(h, jnp.bfloat16)),
        tqc.act("x", _t(h).to(torch.bfloat16)))


def test_unported_quant_options_raise(smoke):
    # train and calibrate are ported; collect and export are replaced by
    # listing (transformer.collect_sites / site_weights)
    with pytest.raises(NotImplementedError, match="collect_sites"):
        QuantContext(mode="collect")
    with pytest.raises(NotImplementedError, match="item 3"):
        tg.gated_fake_quant(torch.zeros((3, 4)), torch.ones((3, 4)),
                            torch.ones(()), True)


def test_mixed_state_and_packed_export_bit_equal(smoke):
    """make_mixed_quant_state's gates are repro's, and the export of that
    state (2-, 4- and 8-bit storage classes, packed and pack=False) is
    bit-equal to repro's: codes, affine terms, colsums, the ledger and the
    accessors of every QuantizedTensor."""
    cfg, params, _, tcfg, tparams = smoke
    jqs = j_make_mixed_quant_state(cfg, params)
    tqs = make_mixed_quant_state(tcfg, tparams, device="cpu")
    assert MIXED_GATE_LEVELS == J_MIXED_GATE_LEVELS
    assert list(tqs["gates"]) == list(jqs["gates"])
    for k, v in jqs["gates"].items():
        _eq(v, tqs["gates"][k])
    for k, v in jqs["betas"].items():
        _eq(v, tqs["betas"][k])
    for pack in (True, False):
        jqw, jledger = j_export_int_model(params, cfg, jqs, pack=pack)
        tqw, tledger = export_int_model(tparams, tcfg, tqs, pack=pack,
                                        device="cpu")
        assert tledger.entries == jledger.entries
        assert sorted(tqw) == sorted(jqw)
        for k, jt in jqw.items():
            t = tqw[k]
            assert (t.storage_bits, t.k, t.packed) \
                == (jt.storage_bits, jt.k, jt.packed)
            for field in ("codes", "scale", "bias", "colsum"):
                _eq(getattr(jt, field), getattr(t, field))
            assert t.codes.is_contiguous()
            _eq(jt.int8_codes(), t.int8_codes())
            _eq(jt.code_colsum(), t.code_colsum())
            _eq(jt.dequantize(), t.dequantize())
            assert (t.codes_bytes(), t.aux_bytes(), t.weight_count()) \
                == (jt.codes_bytes(), jt.aux_bytes(), jt.weight_count())
    # the site -> storage class map of the mixed state; packed codes are
    # smaller than the pack=False oracle layout (tqw, the last export)
    packed, _ = export_int_model(tparams, tcfg, tqs, device="cpu")
    bits = {k.rsplit("/", 1)[-1]: q.storage_bits for k, q in packed.items()}
    assert bits == {"head.w": 2, "attn_q.w": 2, "mlp_gate.w": 2,
                    "attn_k.w": 4, "attn_v.w": 4, "mlp_up.w": 4,
                    "attn_o.w": 8, "mlp_down.w": 8}
    assert all(q.codes.dtype == (torch.uint8 if q.packed else torch.int8)
               for q in packed.values())
    assert sum(q.codes_bytes() for q in packed.values()) \
        < sum(q.codes_bytes() for q in tqw.values())
