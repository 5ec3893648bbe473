"""The port's CGMQ core against repro: K3's plain version, the STE, BOPs,
directions, the controller, Adam and calibration.

Same inputs, made from a seed with numpy, go through ``repro`` (JAX, on
the CPU; its Pallas kernel in interpret mode) and ``repro_torch``
(``device="cpu"``, where the K3 wrapper takes its plain version). Each
test states its tolerance and why: grid arithmetic done in the same order
is bit-equal; sums taken in another order are held to a few fp32 (or
bf16) steps of their magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import shared_compile_cache  # noqa: F401 (autouse)
from repro.configs import get_smoke_config as j_smoke
from repro.core import bop as jbop
from repro.core import calibration as jcal
from repro.core import controller as jctrl
from repro.core import directions as jdir
from repro.core import gates as jgates
from repro.core.sites import QuantConfig as JQuantConfig
from repro.core.sites import SiteInfo as JSiteInfo
from repro.core.sites import total_gate_count as j_total_gate_count
from repro.kernels.fake_quant.fake_quant import fake_quant_pallas
from repro.kernels.fake_quant.ref import fake_quant_ref as j_fq_ref
from repro.models import transformer as jtfm
from repro.optim import adam as jadam
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import bop as tbop
from repro_torch.core import calibration as tcal
from repro_torch.core import controller as tctrl
from repro_torch.core import directions as tdir
from repro_torch.core import gates as tgates
from repro_torch.core.sites import (QuantConfig, SiteInfo, init_gates,
                                    init_ranges_from_weights,
                                    split_learnable_ranges, total_gate_count)
from repro_torch.kernels.fake_quant.fake_quant import fake_quant
from repro_torch.kernels.fake_quant.ops import fake_quant_op
from repro_torch.kernels.fake_quant.ref import fake_quant_ref
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adam as tadam

# fp32 sums of up to a few hundred terms taken in another order
F32_RTOL = 1e-6
# One bf16 step (8 significant bits) is at most 2^-7 of a value: e.g. bf16
# dbeta, where repro and the port both sum bf16 products in fp32 and round
# the sum to bf16 once, in another order, so the two roundings may land one
# step apart.
BF16_STEP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) \
        if jnp.asarray(a).dtype == jnp.bfloat16 else np.asarray(a)


def _tn(t):
    return t.detach().to(torch.float32).numpy() \
        if t.dtype == torch.bfloat16 else t.detach().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)


# ---------------------------------------------------------------------------
# K3's plain version and the STE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 32), (33, 65), (300, 257)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("signed", [True, False])
def test_fake_quant_plain_bit_equal_to_pallas_and_ref(shape, bf16, signed):
    """K3's plain version (and ``fake_quant_op`` over it) against repro's
    ref bit for bit: the same fp32 grid arithmetic in the same order.
    Against repro's Pallas kernel in interpret mode, within one fp32 step
    of |q| (one bf16 step for bf16 x): XLA's CPU compiler contracts the
    kernel body's ``alpha + s * r`` into a fused multiply-add, which the
    eager ref, the port's plain version and K3 (``__fadd_rn`` of
    ``__fmul_rn``) do not; the two then differ by one rounding of the
    product. Per-channel gates span every level from below the 0.5 clamp
    to 32 bits; a scalar gate too."""
    rng = np.random.default_rng(sum(shape) + 2 * bf16 + signed)
    m, n = shape
    x = rng.normal(size=shape).astype(np.float32) * 1.5
    gate = rng.uniform(0.2, 5.5, size=(n,)).astype(np.float32)
    beta = rng.uniform(0.3, 2.0, size=(n,)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 \
        else (jnp.float32, torch.float32)
    jx = jnp.asarray(x, jdt)
    tx = _t(x).to(tdt)
    want = _np(j_fq_ref(jx.astype(jnp.float32), jnp.asarray(gate),
                        jnp.asarray(beta), signed).astype(jdt))
    pallas = _np(fake_quant_pallas(jx.astype(jnp.float32), jnp.asarray(gate),
                                   jnp.asarray(beta), signed,
                                   interpret=True).astype(jdt))
    before = fake_quant.launches
    got_ref = _tn(fake_quant_ref(tx, _t(gate), _t(beta), signed))
    got_op = fake_quant_op(tx, _t(gate), _t(beta), signed)
    assert got_op.dtype == tdt and fake_quant.launches == before
    np.testing.assert_array_equal(got_ref, want)
    np.testing.assert_array_equal(_tn(got_op), want)
    # one rounding of s*r (|s*r| <= 2 beta), and for bf16 x the bf16
    # rounding that it may tip
    tol = 2.0 ** -22 * beta + (BF16_STEP * np.abs(pallas) if bf16 else 0.0)
    assert (np.abs(got_ref - pallas) <= tol).all()
    # per-tensor: one gate and one range for every column
    g0, b0 = float(gate[0]), float(beta[0])
    want = j_fq_ref(jx.astype(jnp.float32), jnp.full((n,), g0),
                    jnp.full((n,), b0), signed).astype(jdt)
    got = fake_quant_op(tx, torch.tensor(g0), torch.tensor(b0), signed)
    np.testing.assert_array_equal(_tn(got), _np(want))


def test_fake_quant_op_rejects_per_weight_gates():
    x = torch.zeros((4, 6))
    with pytest.raises(NotImplementedError, match="item 3"):
        fake_quant_op(x, torch.ones((4, 6)), torch.ones(()), True)
    with pytest.raises(NotImplementedError, match="item 3"):
        tgates.gated_fake_quant(x, torch.ones((4, 6)), torch.ones(()), True)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("per_channel", [False, True])
def test_gated_fake_quant_forward_and_vjp(bf16, signed, per_channel):
    """Forward and dx bit-equal to ``jax.vjp(gated_fake_quant)``; dbeta
    within F32_RTOL (fp32 x) or one bf16 step (bf16 x) of its magnitude.
    Activation-site layout: x (B, S, N), gate/beta broadcast from (1, 1, N)
    or a scalar; the gates cycle through every bit level."""
    rng = np.random.default_rng(7 + 4 * bf16 + 2 * signed + per_channel)
    b, s, n = 3, 7, 40
    x = rng.normal(size=(b, s, n)).astype(np.float32)
    ct = rng.normal(size=(b, s, n)).astype(np.float32)
    levels = np.array([0.3, 0.8, 1.5, 2.5, 3.5, 5.5], np.float32)
    if per_channel:
        gate = levels[np.arange(n) % len(levels)].reshape(1, 1, n)
        beta = rng.uniform(0.5, 2.0, size=(1, 1, n)).astype(np.float32)
    else:
        gate, beta = np.float32(2.5), np.float32(1.3)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 \
        else (jnp.float32, torch.float32)
    out, vjp = jax.vjp(
        lambda x_, b_: jgates.gated_fake_quant(x_, jnp.asarray(gate), b_,
                                               signed),
        jnp.asarray(x, jdt), jnp.asarray(beta))
    jdx, jdb = vjp(jnp.asarray(ct, jdt))
    tx = _t(x).to(tdt).requires_grad_()
    tb = _t(beta).requires_grad_()
    got = tgates.gated_fake_quant(tx, _t(gate), tb, signed)
    got.backward(_t(ct).to(tdt))
    assert got.dtype == tdt and tb.grad.shape == tb.shape
    np.testing.assert_array_equal(_tn(got), _np(out))
    np.testing.assert_array_equal(_tn(tx.grad), _np(jdx))
    tol = BF16_STEP if bf16 else F32_RTOL
    err = np.abs(_tn(tb.grad) - _np(jdb))
    assert (err <= tol * np.abs(_np(jdb)) + 1e-6).all(), err.max()


@pytest.mark.parametrize("g", [0.3, 0.8, 1.5, 2.5, 3.5, 5.5])
def test_residual_equals_gated_and_repro(g):
    """Paper Eq. 3 telescopes to Q(x, T(g)), as tests/test_gates.py checks
    for repro (1e-6), and equals repro's residual chain bit for bit."""
    rng = np.random.default_rng(int(g * 10))
    x = rng.normal(size=(64,)).astype(np.float32) * 1.2
    for signed in (True, False):
        r = tgates.residual_fake_quant(_t(x), torch.tensor(g),
                                       torch.tensor(1.2), signed)
        d = tgates.gated_fake_quant(_t(x), torch.tensor(g),
                                    torch.tensor(1.2), signed)
        np.testing.assert_allclose(r.numpy(), d.numpy(), rtol=1e-6,
                                   atol=1e-6)
        jr = jgates.residual_fake_quant(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(1.2), signed)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


# ---------------------------------------------------------------------------
# BOP
# ---------------------------------------------------------------------------


def _jsites(tsites):
    return {k: JSiteInfo(**dataclasses.asdict(s)) for k, s in tsites.items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b-smoke", "tinyllama-1.1b"])
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
def test_bop_equals_repro(arch, granularity):
    """site_bop, model_bop, fp32_bop, min_bop, rbop and budget_from_rbop
    on the listed sites (fed to repro as its own SiteInfo) with stacked
    random gates: sums of integers times powers of two in the same order,
    so equal."""
    tsites = ttfm.collect_sites(get_config(arch))
    jsites = _jsites(tsites)
    assert list(jsites) == list(ttfm.collect_sites(
        get_smoke_config("tinyllama-1.1b") if arch.endswith("smoke")
        else get_config(arch)))
    qcfg = QuantConfig(granularity=granularity)
    shapes = {k: tuple(v.shape) for k, v in init_gates(
        tsites, qcfg, 1.0, "cpu").items()}
    rng = np.random.default_rng(3)
    gates = {k: rng.uniform(0.2, 5.5, size=s).astype(np.float32)
             for k, s in shapes.items()}
    tg = {k: _t(v) for k, v in gates.items()}
    jg = {k: jnp.asarray(v) for k, v in gates.items()}
    for name, s in tsites.items():
        got = tbop.site_bop(s, tg.get(name + ".w"), tg.get(name + ".a"))
        want = jbop.site_bop(jsites[name], jg.get(name + ".w"),
                             jg.get(name + ".a"))
        assert float(got) == float(want), name
    assert float(tbop.model_bop(tsites, tg)) \
        == float(jbop.model_bop(jsites, jg))
    assert float(tbop.rbop(tsites, tg)) == float(jbop.rbop(jsites, jg))
    assert tbop.fp32_bop(tsites) == jbop.fp32_bop(jsites)
    assert tbop.min_bop(tsites) == jbop.min_bop(jsites)
    assert tbop.budget_from_rbop(tsites, 0.07) \
        == jbop.budget_from_rbop(jsites, 0.07)
    assert total_gate_count(tg) == j_total_gate_count(jg)


# ---------------------------------------------------------------------------
# Directions and the controller
# ---------------------------------------------------------------------------


def _stats(seed, shapes):
    rng = np.random.default_rng(seed)
    gates = {k: rng.uniform(0.5, 6.0, size=s).astype(np.float32)
             for k, s in shapes.items()}
    grads = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** rng.uniform(
        -4, 1) for k, s in shapes.items()}
    mags = {k: np.abs(rng.normal(size=s)).astype(np.float32) * 0.1
            for k, s in shapes.items()}
    return gates, grads, mags


SHAPES = {"a.w": (), "a.a": (3,), "b.w": (4,), "b.a": (), "c.w": (2, 5)}


@pytest.mark.parametrize("kind", ["dir1", "dir2", "dir3", "dir4"])
@pytest.mark.parametrize("sat", [False, True])
@pytest.mark.parametrize("clip", [None, 10.0])
def test_directions_equal_repro(kind, sat, clip):
    gates, grads, mags = _stats(11, SHAPES)
    want = jdir.compute_directions(
        kind, jnp.asarray(sat), {k: jnp.asarray(v) for k, v in gates.items()},
        {k: jnp.abs(jnp.asarray(v)) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in mags.items()}, clip=clip)
    got = tdir.compute_directions(
        kind, torch.tensor(sat), {k: _t(v) for k, v in gates.items()},
        {k: _t(v).abs() for k, v in grads.items()},
        {k: _t(v) for k, v in mags.items()}, clip=clip)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=F32_RTOL, atol=0)
    assert tdir.check_direction_properties(got, sat)


@pytest.mark.parametrize("check_every", [1, 2])
def test_controller_update_equals_repro(check_every):
    """Three updates from the same statistics (probe gradients, weight and
    activation stats, an activation key without any), per-tensor and
    per-channel gates, a budget the gates cross: gates within F32_RTOL,
    sat, bop, best_gates and best_valid equal at every step."""
    shapes = {"s/x.w": (3,), "s/x.a": (3,), "s/y.w": (3, 4), "s/y.a": (3, 4),
              "head.w": ()}
    sites = {
        "s/x": SiteInfo("s/x", (8, 4), 8, 4, 1, 3, 1.0, True),
        "s/y": SiteInfo("s/y", (4, 4), 4, 4, 1, 3, 1.0, True),
        "head": SiteInfo("head", (4, 9), 4, 9, 1, 1, 1.0, False)}
    jsites = _jsites(sites)
    rng = np.random.default_rng(5)
    gates = {k: np.full(s, 3.05, np.float32) + rng.uniform(
        0, 0.3, size=s).astype(np.float32) for k, s in shapes.items()}
    _, grads, mags = _stats(12, shapes)
    astats = {"s/x.a": {"mean_abs": mags["s/x.a"]}}
    wstats = {k: v for k, v in mags.items() if k.endswith(".w")}
    cfg = dict(budget_rbop=0.07, direction="dir2", gate_lr=0.05,
               check_every=check_every, dir_clip=10.0)
    jcfg, tcfg = jctrl.CGMQConfig(**cfg), tctrl.CGMQConfig(**cfg)
    budget = jbop.budget_from_rbop(jsites, 0.07)
    assert budget == tbop.budget_from_rbop(sites, 0.07)
    js = jctrl.init_state({k: jnp.asarray(v) for k, v in gates.items()},
                          jsites)
    ts = tctrl.init_state({k: _t(v) for k, v in gates.items()}, sites)
    sats = []
    for _ in range(3):
        js = jctrl.controller_update(
            js, jcfg, jsites, {k: jnp.asarray(v) for k, v in grads.items()},
            {k: jnp.asarray(v) for k, v in wstats.items()},
            {k: {"mean_abs": jnp.asarray(v["mean_abs"])}
             for k, v in astats.items()}, budget)
        ts = tctrl.controller_update(
            ts, tcfg, sites, {k: _t(v) for k, v in grads.items()},
            {k: _t(v) for k, v in wstats.items()},
            {k: {"mean_abs": _t(v["mean_abs"])} for k, v in astats.items()},
            budget)
        for k in shapes:
            np.testing.assert_allclose(ts.gates[k].numpy(),
                                       np.asarray(js.gates[k]),
                                       rtol=F32_RTOL, atol=0)
            np.testing.assert_array_equal(ts.best_gates[k].numpy(),
                                          np.asarray(js.best_gates[k]))
        assert bool(ts.sat) == bool(js.sat)
        assert float(ts.bop) == float(js.bop)
        assert bool(ts.best_valid) == bool(js.best_valid)
        assert int(ts.step) == int(js.step)
        sats.append(bool(ts.sat))
    assert len(set(sats)) == 2 and sats[-1]   # the flag moved: both branches
    assert tctrl.guarantee_satisfied(ts, sites, budget)
    for k, v in tctrl.export_bits(ts).items():
        np.testing.assert_array_equal(v, np.asarray(jctrl.export_bits(js)[k]))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


def test_adam_equals_repro():
    """Three clipped Adam updates of a small (params, betas) tree: within
    F32_RTOL of repro's (the global norm is a sum over leaves in another
    order)."""
    rng = np.random.default_rng(9)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "blocks": [{"b": rng.normal(size=(2, 4)).astype(np.float32)}]}
    betas = {"s.w": np.float32(1.0), "s.a": np.ones((2,), np.float32)}
    cfg = dict(lr=1e-2, grad_clip_norm=1.0)
    jinit, jupd = jadam.adam(jadam.AdamConfig(**cfg))
    tinit, tupd = tadam.adam(tadam.AdamConfig(**cfg))
    jp = jax.tree.map(jnp.asarray, (params, betas))
    tp = bridge.params_from_numpy((params, betas), device="cpu")
    jst, tst = jinit(jp), tinit(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(
            np.float32) * 3.0, (params, betas))
        ju, jst = jupd(jax.tree.map(jnp.asarray, g), jst, jp)
        tu, tst = tupd(bridge.params_from_numpy(g, device="cpu"), tst, tp)
        jp, tp = jadam.apply_updates(jp, ju), tadam.apply_updates(tp, tu)
        for a, b in zip(jax.tree.leaves(jp),
                        jax.tree.leaves(bridge.tree_to_numpy(tp))):
            assert _rel(a, b) <= F32_RTOL
    assert int(tst.step) == 3
    with pytest.raises(NotImplementedError, match="item 3"):
        tadam.AdamConfig(state_bits=8)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def test_calibration_of_the_smoke_model_equals_repro():
    """Running-max activation ranges of the smoke model over two batches.
    The maxima are of bf16 activations that the two packages compute with
    fp32 sums in another order, so a maximum may sit a bf16 step or a few
    apart; the running mean 0.9 m1 + 0.1 m2 keeps that bound relative to
    the larger batch max. Signs are equal."""
    cfg = j_smoke("tinyllama-1.1b")
    params = jtfm.init_params(cfg, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    tcfg = get_smoke_config("tinyllama-1.1b")
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab_size, (2, 12)) for _ in range(2)]
    # a per-tensor max (over 24 tokens x all channels) moved at most one
    # step here (0.65 measured); a per-channel max is one token's value,
    # which carries the bf16 noise of every layer below it (up to 3.3 steps
    # measured in the second layer's mlp_up)
    for gran, steps in (("per_tensor", 1), ("per_channel", 4)):
        def run(bs):
            return jcal.calibrate_activations(
                lambda qc, b: jtfm.forward_train(qc, params, b, cfg),
                [jnp.asarray(b) for b in bs], JQuantConfig(granularity=gran))

        want = run(batches)
        single = [run([b]) for b in batches]
        got = tcal.calibrate_activations(
            lambda qc, b: ttfm.forward_train(qc, tparams, b, tcfg),
            [_t(b) for b in batches], QuantConfig(granularity=gran))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k]["signed"] == v["signed"]
            a, b = np.asarray(v["beta"]), got[k]["beta"].numpy()
            assert a.shape == b.shape
            # 0.9 m1 + 0.1 m2 moves by at most one step of the larger max
            peak = np.maximum(*(np.asarray(s1[k]["beta"]) for s1 in single))
            assert (np.abs(b - a) <= steps * BF16_STEP * peak).all(), k
        # applied to placeholder ranges of the gate's shape
        sites = ttfm.collect_sites(tcfg)
        ranges = tcal.apply_act_calibration(init_ranges_from_weights(
            sites, QuantConfig(granularity=gran), lambda n: None, "cpu"), got)
        for k in got:
            assert ranges[k]["beta"].shape == (
                (2,) if gran == "per_tensor" else (2, sites[k[:-2]]
                                                   .out_features))
        assert split_learnable_ranges(ranges)[1][k] == got[k]["signed"]
    stacked = tcal.stack_act_ranges([got, got])
    assert stacked[k]["beta"].shape == (2,) + tuple(got[k]["beta"].shape)

