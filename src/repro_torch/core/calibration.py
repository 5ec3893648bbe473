"""Quantization-range calibration (paper §2.4).

Counterpart of ``repro/core/calibration.py``. Given an fp32-warmed model,
the activation ranges start from a running mean (momentum 0.1) of each
site's per-batch max |a| (per channel for per-channel activation gates),
and a site is signed once any calibration batch shows a negative
activation. Weight ranges come from the weights (``sites.
init_ranges_from_weights``), or are learned from their placeholders.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .sites import PER_CHANNEL, QuantConfig, QuantContext

MOMENTUM = 0.1


def calibrate_activations(forward: Callable, batches, cfg: QuantConfig,
                          momentum: float = MOMENTUM) -> dict[str, dict]:
    """Run calibration batches through ``forward(qc, batch)`` under
    ``torch.no_grad``.

    Returns ``{act_key: {"beta": running max (a tensor on the forward's
    device), "signed": bool}}``. Stacked sites report one value per layer
    (the model stacks its layers' stats), so their betas are ``(R,)``.
    The running mean is taken in numpy fp32, as ``repro`` takes it.
    """
    running: dict[str, dict[str, Any]] = {}
    device = None
    for batch in batches:
        qc = QuantContext(mode="calibrate", cfg=cfg)
        with torch.no_grad():
            forward(qc, batch)
        for key, st in qc.act_stats.items():
            device = st["max"].device
            per_ch = cfg.act_granularity == PER_CHANNEL
            mx = st["max_per_ch"] if per_ch and "max_per_ch" in st \
                else st["max"]
            mx = mx.to(torch.float32).cpu().numpy()
            neg = bool((st["min"] < 0).any())
            if key not in running:
                running[key] = {"beta": mx, "signed": neg}
            else:
                r = running[key]
                r["beta"] = (1 - momentum) * r["beta"] + momentum * mx
                r["signed"] = r["signed"] or neg
    return {k: {"beta": torch.from_numpy(np.asarray(v["beta"], np.float32))
                .to(device),
                "signed": bool(v["signed"])}
            for k, v in running.items()}


def apply_act_calibration(ranges: dict[str, Any],
                          act_ranges: dict[str, dict[str, Any]]):
    """Overwrite placeholder activation ranges with calibrated ones,
    broadcast to each range's shape."""
    out = dict(ranges)
    for key, v in act_ranges.items():
        if key in out:
            base = out[key]["beta"]
            beta = torch.as_tensor(v["beta"], dtype=torch.float32,
                                   device=base.device)
            out[key] = {"beta": torch.broadcast_to(beta, base.shape).clone(),
                        "signed": bool(v["signed"])}
    return out


def stack_act_ranges(per_layer: list[dict[str, dict[str, Any]]]):
    """Stack per-layer calibration results for stacked sites."""
    return {k: {"beta": torch.stack([torch.as_tensor(p[k]["beta"])
                                     for p in per_layer]),
                "signed": any(bool(p[k]["signed"]) for p in per_layer)}
            for k in per_layer[0]}
