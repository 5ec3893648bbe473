"""Hand ``repro``'s parameters, quant state, activation specs and train
state to the port, and the port's tensors back, through numpy.

The caller does the JAX-to-numpy step (``jax.tree.map(np.asarray,
params)``); this module never imports JAX. Parameters keep ``repro``'s
layout, so the conversion is leaf by leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.controller import CGMQState
from repro_torch.core.sites import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.optim.adam import AdamState
from repro_torch.quant.spec import ActQuantSpec
from repro_torch.train.state import TrainState


def _to_tensor(a, dev):
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree, device=None):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _to_tensor(t, dev)

    return conv(tree)


def quant_state_from_numpy(gates: dict, betas: dict, signed: dict,
                           qcfg_fields: dict, device=None) -> dict:
    """``repro``'s quant state (numpy gates/betas, bool signed map, and
    ``dataclasses.asdict`` of its ``QuantConfig``) -> the port's."""
    dev = resolve_device(device)
    return {"qcfg": QuantConfig(**qcfg_fields),
            "gates": {k: _to_tensor(v, dev) for k, v in gates.items()},
            "betas": {k: _to_tensor(v, dev) for k, v in betas.items()},
            "signed": {k: bool(v) for k, v in signed.items()}}


def act_specs_from_numpy(specs: dict, device=None) -> dict:
    """``repro``'s ``{"<site>.in": ActQuantSpec}`` with numpy betas
    (``jax.tree.map(np.asarray, specs)``) -> the port's ``ActQuantSpec``s,
    read by attribute (``bits``, ``beta``, ``signed``)."""
    dev = resolve_device(device)
    return {k: ActQuantSpec(bits=int(s.bits),
                            beta=_to_tensor(np.asarray(s.beta, np.float32),
                                            dev),
                            signed=bool(s.signed))
            for k, s in specs.items()}


def train_state_from_numpy(state, device=None) -> TrainState:
    """``repro``'s ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's: params, betas,
    the Adam moments and step, the controller state (gates, sat, bop,
    step, best_gates, best_valid), the probes and the step. The PRNG key
    becomes an int64 tensor of its words. Read by attribute, so the port
    needs none of ``repro``'s classes."""
    dev = resolve_device(device)

    def conv(tree):
        return params_from_numpy(tree, device=dev)

    c = state.cgmq
    return TrainState(
        params=conv(state.params), betas=conv(state.betas),
        opt=AdamState(step=conv(state.opt.step), m=conv(state.opt.m),
                      v=conv(state.opt.v)),
        cgmq=CGMQState(gates=conv(c.gates), sat=conv(c.sat),
                       bop=conv(c.bop), step=conv(c.step),
                       best_gates=conv(c.best_gates),
                       best_valid=conv(c.best_valid)),
        probes=conv(state.probes),
        rng=None if state.rng is None else _to_tensor(
            np.asarray(state.rng).astype(np.int64), dev),
        step=None if state.step is None else conv(state.step))


def tree_to_numpy(tree):
    """Tensors -> numpy arrays through dicts, lists, tuples (named ones
    too) and dataclasses; bf16 comes back as float32 (numpy has no
    bfloat16, and the widening is exact)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_to_numpy(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return tree
