"""The port's CGMQ train step against repro's, on the smoke tinyllama.

The state is built in repro (``PRNGKey(0)``) and handed over with
``bridge.train_state_from_numpy``; both packages then take the same
``lm_tokens`` batch. repro's gradients come from ``jax.value_and_grad`` of
the composition ``launch/steps.py:make_train_step``'s ``loss_fn`` makes;
the port's from ``launch.steps.loss_and_grads``.

Tolerances, and why. Both packages keep activations in bf16 between
matmuls and sum each product in fp32 in their own order, so a bf16
rounding now and then lands one step apart, and the layers above carry it.
That moves the loss by ~1e-4 of itself and a gradient leaf by ~1% of its
norm (measured: ``PERF.md``, "CPU parity"). A probe's gradient is a sum
over a whole tensor of terms of both signs, so its error is held relative
to the sum of the terms' magnitudes (its L1 mass), not to the sum.
Quantization grids finer than a bf16 step (8 and 16 bits) turn each such
bf16 difference into a different code, and coarse grids (2 and 4 bits)
after them into a different whole step, so with every activation site
quantized the gradients of the two packages part by far more than 2%
(~45% measured); that run is held to the controller's outputs, which are
piecewise constant: Sat flags, BOPs, the certified snapshot's bit-widths.
"""

import dataclasses
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_env import (  # noqa: F401 (autouse)
    one_torch_thread, shared_compile_cache)
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import bop as jbop
from repro.core import controller as jctrl
from repro.core.gates import gate_to_bits as j_gate_to_bits
from repro.core.sites import QuantContext as JQuantContext
from repro.core.sites import merge_ranges as j_merge_ranges
from repro.data.synthetic import lm_tokens as j_lm_tokens
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import controller as tctrl
from repro_torch.core import sites as tsites
from repro_torch.core.gates import gate_to_bits
from repro_torch.data.synthetic import lm_tokens
from repro_torch.kernels.fake_quant.fake_quant import fake_quant
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm

ARCH = "tinyllama-1.1b"
BATCH, SEQ = 2, 16
LOSS_RTOL = 1e-3        # of the loss
GRAD_RTOL = 2e-2        # of a leaf's L2 norm; of a probe sum's L1 mass
CTRL_ATOL = 1e-6        # new gates from the same statistics: fp32 steps
# gates cycled site by site, 2/4/8/16 bits, as in the serving stand-ins
LEVELS = (0.8, 1.5, 2.5, 3.5)


def _cycled(gates, which=".wa"):
    """Gates cycled through LEVELS in sorted key order; keys whose suffix
    is not in ``which`` keep the init value (5.5, 32-bit)."""
    return {k: jnp.full_like(v, LEVELS[i % len(LEVELS)] if k[-1] in which
                             else v)
            for i, (k, v) in enumerate(sorted(gates.items()))}


def _batch(seed=0):
    data = j_lm_tokens(64, SEQ, j_smoke(ARCH).vocab_size, seed=seed,
                       noise=0.05)
    chunk = data[:BATCH]
    return {"tokens": chunk[:, :-1], "targets": chunk[:, 1:]}


@pytest.fixture(scope="module")
def repro_side():
    cfg = j_smoke(ARCH)
    shape = JShapeConfig("train", seq_len=SEQ, global_batch=BATCH,
                         kind="train")
    recipe = jsteps.make_recipe(cfg, shape, check_every=1)
    state = jsteps.init_train_state(recipe, jax.random.PRNGKey(0))

    def loss_fn(params, betas, probes, gates, batch):
        qc = JQuantContext(mode="train", cfg=recipe.qcfg, gates=gates,
                           ranges=j_merge_ranges(betas, recipe.signed),
                           probes=probes)
        logits = jtfm.forward_train(qc, params, batch["tokens"], cfg)
        loss = jsteps.vocab_parallel_xent(None, logits, batch["targets"],
                                          cfg.vocab_size)
        return loss, (qc.act_stats, qc.weight_stats)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2),
                                         has_aux=True))
    return cfg, shape, recipe, state, grad_fn


def _port(recipe_kwargs, jstate):
    tcfg = get_smoke_config(ARCH)
    shape = ShapeConfig("train", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    recipe = tsteps.make_recipe(tcfg, shape, **recipe_kwargs)
    return recipe, bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")


def _rel_l2(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _act_grad_mass(recipe, state, batch):
    """Sum over batch and sequence of |dL/da| at every fake-quantized
    activation, by layer (the L1 mass of each activation probe's
    gradient), from the port's backward through tensor hooks."""
    mass = {}

    class Hooked(tsites.QuantContext):
        def act(self, name, a):
            out = super().act(name, a)
            key = self._full(name) + ".a"
            if a.requires_grad:
                a.register_hook(lambda g, key=key: mass.setdefault(
                    key, []).append(g.float().abs().sum(dim=(0, 1))))
            return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tsites, "QuantContext", Hooked)
    mp.setattr(tsteps, "QuantContext", Hooked)
    try:
        tsteps.loss_and_grads(recipe, state, batch)
    finally:
        mp.undo()
    # hooks fire in backward order: the last layer first
    return {k: torch.stack(v[::-1]).sum(dim=-1) for k, v in mass.items()}


def _compare_step(repro_side, which):
    cfg, shape, jrecipe, jstate, grad_fn = repro_side
    if which:
        jstate = dataclasses.replace(jstate, cgmq=jctrl.init_state(
            _cycled(jstate.cgmq.gates, which), jrecipe.sites))
    batch = _batch()
    (jl, (ja, jw)), (jgp, jgb, jgprobe) = grad_fn(
        jstate.params, jstate.betas, jstate.probes, jstate.cgmq.gates,
        jax.tree.map(jnp.asarray, batch))
    recipe, tstate = _port({"check_every": 1}, jstate)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tl, (tgp, tgb, tgprobe), ta, tw = tsteps.loss_and_grads(
        recipe, tstate, tb)
    out = {"loss": abs(float(tl) - float(jl)) / abs(float(jl))}
    gp = bridge.tree_to_numpy(tgp)
    out["params"] = max(_rel_l2(a, b) for a, b in zip(
        jax.tree.leaves(jgp), jax.tree.leaves(gp)))
    # A probe's or a beta's gradient is a sum over its site's tensor: of
    # dL/dw (weight probe), dL/da (activation probe) or dL/dq * dq/dbeta
    # with |dq/dbeta| <= 1 (beta). Each is held relative to the L1 mass of
    # the weight's or the activation's gradient.
    mass = {k: np.abs(np.asarray(v, np.float64)).reshape(
        v.shape[0] if v.ndim == 3 else 1, -1).sum(axis=1).reshape(
        np.shape(jgprobe[k]))
        for k, v in ttfm.site_weights(jax.tree.map(np.asarray, jgp),
                                      get_smoke_config(ARCH)).items()}
    mass.update({k: v.numpy() for k, v in _act_grad_mass(
        recipe, tstate, tb).items()})
    for name, want, got in (("probes", jgprobe, tgprobe),
                            ("betas", jgb, tgb)):
        err = []
        for k, v in want.items():
            d = np.abs(got[k].numpy() - np.asarray(v))
            # sites the forward never reaches: zero on both sides
            err.append(float((d / mass[k]).max()) if k in mass
                       else np.inf if d.any() else 0.0)
        out[name] = max(err)
    # the controller: from repro's statistics exactly, from its own close
    jnew = jctrl.controller_update(jstate.cgmq, jrecipe.ccfg, jrecipe.sites,
                                   jgprobe, jw, ja, jrecipe.budget_bop)
    same = tctrl.controller_update(
        tstate.cgmq, recipe.ccfg, recipe.sites,
        bridge.params_from_numpy(jax.tree.map(np.asarray, jgprobe), "cpu"),
        bridge.params_from_numpy(jax.tree.map(np.asarray, jw), "cpu"),
        bridge.params_from_numpy(jax.tree.map(np.asarray, ja), "cpu"),
        recipe.budget_bop)
    own = tctrl.controller_update(tstate.cgmq, recipe.ccfg, recipe.sites,
                                  tgprobe, tw, ta, recipe.budget_bop)
    out["gates_same_stats"] = max(
        float(np.abs(same.gates[k].numpy() - np.asarray(v)).max())
        for k, v in jnew.gates.items())
    out["gates_own_stats"] = max(
        float(np.abs(own.gates[k].numpy() - np.asarray(v)).max())
        for k, v in jnew.gates.items())
    for st in (same, own):
        assert bool(st.sat) == bool(jnew.sat)
        assert float(st.bop) == float(jnew.bop)
        for k, v in jnew.gates.items():
            np.testing.assert_array_equal(gate_to_bits(st.gates[k]).numpy(),
                                          np.asarray(j_gate_to_bits(v)))
    return out


@pytest.mark.parametrize("which", ["", ".w"], ids=["init", "mixed_weights"])
def test_train_step_gradients_match_repro(repro_side, which):
    """One CGMQ step from repro's state: at init_train_state's gates (5.5,
    32-bit, where K3 passes through) and with the weight gates cycled over
    2/4/8/16 bits. Loss, every param gradient leaf and every probe
    gradient within the stated tolerances, beta gradients equal (all zero
    at 32 bits), and the controller: from repro's statistics its new gates
    within CTRL_ATOL, from its own on the same bit-widths, Sat and BOP
    equal either way."""
    out = _compare_step(repro_side, which)
    print(which or "init", out)
    assert out["loss"] <= LOSS_RTOL
    assert out["params"] <= GRAD_RTOL
    assert out["betas"] <= GRAD_RTOL
    assert out["probes"] <= GRAD_RTOL
    assert out["gates_same_stats"] <= CTRL_ATOL


def test_recipe_matches_repro(repro_side):
    cfg, shape, jrecipe, _, _ = repro_side
    recipe, _ = _port({"check_every": 1}, repro_side[3])
    assert list(recipe.sites) == list(jrecipe.sites)
    for k, s in recipe.sites.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jrecipe.sites[k])
    assert recipe.signed == jrecipe.signed
    assert recipe.budget_bop == jrecipe.budget_bop
    assert dataclasses.asdict(recipe.ccfg) == dataclasses.asdict(
        jrecipe.ccfg)
    assert (recipe.adam.lr, recipe.adam.grad_clip_norm,
            recipe.adam.state_bits) == (jrecipe.adam.lr,
                                        jrecipe.adam.grad_clip_norm,
                                        jrecipe.adam.state_bits)
    with pytest.raises(NotImplementedError, match="item 3"):
        tsteps.make_recipe(dataclasses.replace(recipe.cfg, d_model=7168),
                           ShapeConfig("train", SEQ, 64, "train"))
    with pytest.raises(NotImplementedError, match="item 16"):
        tsteps.vocab_parallel_xent(object(), None, None, 1)


# the activation gates no forward reaches (their outputs are not
# fake-quantized, as in repro): zero statistics, so the clipped direction
# moves them by exactly gate_lr * dir_clip = 0.1 a step in both packages
UNUSED_ACTS = ("attn_q.a", "attn_k.a", "attn_v.a", "mlp_gate.a")
# every activation site quantized at 2-16 bits: from the same state the two
# losses part by the grid flips the module docstring describes (1.9e-3
# measured); after an Adam step, whose first update is lr * sign(g), every
# gradient entry whose sign the noise flips moves the other way, and the
# trajectories part further (1.5% at the second step), so only the first
# loss is compared
MIXED_LOSS_RTOL = 1e-2


def test_train_steps_certify_like_repro(repro_side):
    """Three CGMQ steps (repro's jitted ``make_train_step`` against the
    port's) from gates cycled over 2/4/8/16 bits, check_every=1, and a
    budget that the third step crosses: the unused activation gates start
    at 2.25 (8 bits) and reach 1.95 (4 bits) at the third step, while
    every other gate moves at most 0.1 a step from the middle of its
    level. Sat (False, False, True), BOP and the certified snapshot's
    bit-widths equal at every step; the deterministic gates equal."""
    cfg, shape, jrecipe0, jstate, _ = repro_side
    gates = {k: jnp.full_like(v, 2.25) if k.endswith(UNUSED_ACTS) else v
             for k, v in _cycled(jstate.cgmq.gates).items()}
    crossed = {k: jnp.full_like(v, 1.95) if k.endswith(UNUSED_ACTS) else v
               for k, v in gates.items()}
    fp = jbop.fp32_bop(jrecipe0.sites)
    b0, b3 = (float(jbop.model_bop(jrecipe0.sites, g)) for g in (gates,
                                                                 crossed))
    assert b3 < b0
    kw = {"check_every": 1, "budget_rbop": (b0 + b3) / 2 / fp}
    jrecipe = jsteps.make_recipe(cfg, shape, **kw)
    jstate = dataclasses.replace(jstate, cgmq=jctrl.init_state(
        gates, jrecipe.sites))
    recipe, tstate = _port(kw, jstate)
    assert recipe.budget_bop == jrecipe.budget_bop
    jstep = jax.jit(jsteps.make_train_step(jrecipe, None))
    tstep = tsteps.make_train_step(recipe)
    data = j_lm_tokens(64, SEQ, cfg.vocab_size, seed=0, noise=0.05)
    np.testing.assert_array_equal(
        data, lm_tokens(64, SEQ, cfg.vocab_size, seed=0, noise=0.05))
    sats = []
    for i in range(3):
        chunk = data[i * BATCH:(i + 1) * BATCH]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(chunk[:, :-1]),
                                    "targets": jnp.asarray(chunk[:, 1:])})
        t = torch.from_numpy(chunk)
        tstate, tm = tstep(tstate, {"tokens": t[:, :-1],
                                    "targets": t[:, 1:]})
        assert np.isfinite(float(tm["loss"]))
        if i == 0:
            assert abs(float(tm["loss"]) - float(jm["loss"])) \
                <= MIXED_LOSS_RTOL * abs(float(jm["loss"]))
        assert bool(tm["sat"]) == bool(jm["sat"])
        assert float(tm["bop"]) == float(jm["bop"])
        assert float(tm["rbop"]) == pytest.approx(float(jm["rbop"]),
                                                  rel=1e-6)
        assert bool(tstate.cgmq.best_valid) == bool(jstate.cgmq.best_valid)
        assert int(tstate.step) == int(jstate.step) == i + 1
        sats.append(bool(tm["sat"]))
    assert sats == [False, False, True]
    for k, v in jstate.cgmq.best_gates.items():
        np.testing.assert_array_equal(
            gate_to_bits(tstate.cgmq.best_gates[k]).numpy(),
            np.asarray(j_gate_to_bits(v)))
        if k.endswith(UNUSED_ACTS):
            np.testing.assert_allclose(tstate.cgmq.best_gates[k].numpy(),
                                       np.asarray(v), rtol=0,
                                       atol=CTRL_ATOL)
    assert tctrl.guarantee_satisfied(tstate.cgmq, recipe.sites,
                                     recipe.budget_bop)
    assert jctrl.guarantee_satisfied(jstate.cgmq, jrecipe.sites,
                                     jrecipe.budget_bop)


def test_launch_train_runs_end_to_end_on_cpu():
    """``python -m repro_torch.launch.train`` on the smoke config, 3 steps,
    batch 2 x 16 tokens: repro's log line, finite, and K3's wrapper took
    its plain version (no launch counted)."""
    before = fake_quant.launches
    buf = io.StringIO()
    with redirect_stdout(buf):
        state = ttrain.main(["--arch", "tinyllama-1.1b-smoke", "--steps",
                             "3", "--batch", "2", "--seq", "16",
                             "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[-1] == "done at step 3"
    step, loss = lines[-2].split()[1], float(lines[-2].split()[3])
    assert step == "3" and np.isfinite(loss) and "sat=" in lines[-2]
    assert int(state.step) == 3 and int(state.cgmq.step) == 3
    assert fake_quant.launches == before
    # the fp32-warmup recipe still moves every gate (no probe is reached)
    recipe = tsteps.make_recipe(get_smoke_config(ARCH), ShapeConfig(
        "train", SEQ, BATCH, "train"), quant_enabled=False)
    before = {k: v.clone() for k, v in state.cgmq.gates.items()}
    chunk = torch.from_numpy(lm_tokens(BATCH, SEQ, 277, seed=1))
    state, m = tsteps.make_train_step(recipe)(
        state, {"tokens": chunk[:, :-1], "targets": chunk[:, 1:]})
    for k, g in state.cgmq.gates.items():
        torch.testing.assert_close(g, torch.clamp(before[k] - 0.1, 0.5, 6.0))
