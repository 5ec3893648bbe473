"""The CGMQ train step of the LLM path.

Counterpart of ``repro/launch/steps.py`` without a mesh: ``make_recipe``
freezes what one arch needs (sites, static signs, the BOP budget, the
controller and Adam configs); ``make_train_step`` builds the step that
``repro``'s ``make_train_step(recipe, None)`` builds: the fake-quant
forward (``tfm.forward_train``, K3 on the card), cross-entropy, the
backward, Adam over ``(params, betas)``, and the CGMQ controller update
from the probe gradients and the forward's statistics. The controller runs
whatever ``quant_enabled`` says, as in ``repro``: during an fp32 warmup no
probe is reached, every direction is the clipped 1/eps, and every gate
falls by ``gate_lr * dir_clip`` per step.

State is ``train.state.TrainState`` (DESIGN.md §9). A step returns a new
state and leaves the old one as it was; nothing in it syncs the host.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import bop as bop_lib
from repro_torch.core import controller as ctrl
from repro_torch.core.gates import GATE_INIT
from repro_torch.core.sites import (QuantConfig, QuantContext, init_gates,
                                    init_probes, init_ranges_from_weights,
                                    merge_ranges, split_learnable_ranges)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.optim.adam import (AdamConfig, adam, apply_updates,
                                    tree_leaves, tree_unflatten)
from repro_torch.train.state import TrainState


def vocab_parallel_xent(plan, logits, targets, vocab: int):
    """Mean cross-entropy over the vocab axis. logits: (B, S, Vp) fp32,
    padded ids already at -1e30; targets: (B, S) ints in [0, vocab)."""
    if plan is not None:
        raise NotImplementedError(
            "the vocab-sharded cross-entropy is ported with ROADMAP queue 1 "
            "item 16 (distributed)")
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].to(torch.int64))
    return -torch.mean(ll)


@dataclasses.dataclass
class Recipe:
    """Everything the train step needs for one arch."""

    cfg: ModelConfig
    qcfg: QuantConfig
    ccfg: ctrl.CGMQConfig
    adam: AdamConfig
    sites: dict
    signed: dict
    budget_bop: float
    quant_enabled: bool = True


def make_recipe(cfg: ModelConfig, shape: ShapeConfig, *, direction="dir2",
                budget_rbop=0.0625, check_every=100, quant_impl="direct",
                quant_enabled=True) -> Recipe:
    """List the sites and freeze the recipe, with ``repro``'s defaults
    (per-tensor gates, dir2, gate_lr 0.01, dir_clip 10, Adam lr 1e-4 with
    global-norm clip 1.0). budget_rbop 6.25% is uniform W8A8. The weight
    ranges' static signs come from placeholders (``lambda n: None``), as in
    ``repro``: the betas are learned, not read off the weights.

    ``repro`` picks 8-bit Adam moments above 2e11 parameters and four
    microbatches at d_model >= 7168 with a global batch that 64 divides;
    neither is ported (ROADMAP queue 1 item 3), so those configs raise."""
    tfm.check_supported(cfg)
    if cfg.param_count() > 2e11 or (cfg.d_model >= 7168 and shape.kind
                                    == "train" and shape.global_batch % 64
                                    == 0):
        raise NotImplementedError(
            f"{cfg.name} at batch {shape.global_batch} needs 8-bit Adam "
            f"moments or microbatches: ROADMAP queue 1 item 3")
    qcfg = QuantConfig(granularity="per_tensor", impl=quant_impl,
                       enabled=quant_enabled)
    sites = tfm.collect_sites(cfg)
    _, signed = split_learnable_ranges(
        init_ranges_from_weights(sites, qcfg, lambda n: None, "cpu"))
    return Recipe(
        cfg=cfg, qcfg=qcfg,
        # dir_clip 10 * lr 0.01 = at most 0.1 gate-units per step
        ccfg=ctrl.CGMQConfig(budget_rbop=budget_rbop, direction=direction,
                             gate_lr=0.01, check_every=check_every,
                             dir_clip=10.0),
        adam=AdamConfig(lr=1e-4, grad_clip_norm=1.0),
        sites=sites, signed=signed,
        budget_bop=bop_lib.budget_from_rbop(sites, budget_rbop),
        quant_enabled=quant_enabled)


def init_probe_taps(recipe: Recipe, gates) -> dict:
    """Activation probes and weight gradient taps, sized from the gates."""
    dev = next(iter(gates.values())).device
    probes = init_probes(recipe.sites, recipe.qcfg, dev)
    for s in recipe.sites.values():
        probes[s.name + ".w"] = torch.zeros_like(gates[s.name + ".w"])
    return probes


def init_train_state(recipe: Recipe, seed: int = 0, device=None) -> TrainState:
    """Random params from ``seed`` (``tfm.init_params``), gates at
    GATE_INIT (32-bit), placeholder ranges, zero Adam moments and probes,
    on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    params = tfm.init_params(recipe.cfg, seed, device=dev)
    gates = init_gates(recipe.sites, recipe.qcfg, GATE_INIT, dev)
    betas, _ = split_learnable_ranges(init_ranges_from_weights(
        recipe.sites, recipe.qcfg, lambda n: None, dev))
    opt_init, _ = adam(recipe.adam)
    return TrainState(
        params=params, betas=betas, opt=opt_init((params, betas)),
        cgmq=ctrl.init_state(gates, recipe.sites),
        probes=init_probe_taps(recipe, gates),
        rng=torch.tensor(seed, dtype=torch.int64, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def loss_and_grads(recipe: Recipe, state: TrainState, batch: dict):
    """One batch's loss and gradients, ``repro``'s ``loss_fn`` under
    ``value_and_grad(argnums=(0, 1, 2))``.

    Returns ``(loss, (gparams, gbetas, gprobes), act_stats,
    weight_stats)``. A leaf the forward does not reach (every beta and
    probe in an fp32 warmup, the unused activation probes) gets a zero
    gradient, as in JAX.
    """
    trees = (state.params, state.betas, state.probes)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(trees)]
    params, betas, probes = tree_unflatten(trees, leaves)
    qc = QuantContext(
        mode="train" if recipe.quant_enabled else "off", cfg=recipe.qcfg,
        gates=state.cgmq.gates, ranges=merge_ranges(betas, recipe.signed),
        probes=probes)
    logits = tfm.forward_train(qc, params, batch["tokens"].to(torch.int64),
                               recipe.cfg)
    loss = vocab_parallel_xent(None, logits, batch["targets"],
                               recipe.cfg.vocab_size)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return (loss.detach(), tree_unflatten(trees, grads), qc.act_stats,
            qc.weight_stats)


def make_train_step(recipe: Recipe):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    (B, S) int ``tokens`` and ``targets`` on the state's device."""
    _, opt_update = adam(recipe.adam)
    fp_bop = bop_lib.fp32_bop(recipe.sites)

    def train_step(state: TrainState, batch: dict):
        loss, (gp, gb, gprobe), astats, wstats = loss_and_grads(
            recipe, state, batch)
        with torch.no_grad():
            upd, opt = opt_update((gp, gb), state.opt,
                                  (state.params, state.betas))
            params, betas = apply_updates((state.params, state.betas), upd)
            cgmq = ctrl.controller_update(
                state.cgmq, recipe.ccfg, recipe.sites, gprobe, wstats,
                astats, recipe.budget_bop)
        metrics = {"loss": loss, "bop": cgmq.bop, "rbop": cgmq.bop / fp_bop,
                   "sat": cgmq.sat}
        return TrainState(
            params=params, betas=betas, opt=opt, cgmq=cgmq,
            probes=state.probes, rng=state.rng,
            step=None if state.step is None else state.step + 1), metrics

    return train_step

