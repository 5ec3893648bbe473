"""Hand ``repro``'s parameters and quant state to the port, through numpy.

The caller does the JAX-to-numpy step (``jax.tree.map(np.asarray,
params)``); this module never imports JAX. Parameters keep ``repro``'s
layout, so the conversion is leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sites import QuantConfig
from repro_torch.device import resolve_device


def _to_tensor(a, dev):
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


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
