"""Gate-update directions (paper §2.3).

Counterpart of ``repro/core/directions.py``. A direction replaces the
(identically zero) gradient of the loss with respect to a gate; SGD takes
``g <- g - lr * dir``, so (i) Unsat => dir > 0 (gates shrink, bit-widths
fall) and (ii) Sat => dir <= 0 (gates may grow back). Per gate group:
``grad_stat`` = |(1/N_b) sum_i grad L|, ``mag_stat`` = group |w| (weights)
or |(1/N_b) sum_i a| (activations)::

  dir_1: Unsat  1 / grad_stat                  Sat  -|g|
  dir_2: Unsat  1 / (grad_stat + mag_stat)     Sat  -(|g| + mag_stat)
  dir_3: Unsat  1 / (grad_stat + mag_stat)     Sat  -(grad_stat + mag_stat)
  dir_4: Unsat  1 / (1 + t / median(t))        Sat  -t / (t + median(t)),
         t = grad_stat + mag_stat, median over every gate group

``clip`` bounds the Unsat branch of dir_1..3 into ``[eps, clip]`` (and the
Sat branch into ``[-clip, 0]``).
"""

from __future__ import annotations

import torch

DIRECTIONS = ("dir1", "dir2", "dir3", "dir4")


def _global_median(stats: dict[str, torch.Tensor]) -> torch.Tensor:
    flat = torch.cat([v.reshape(-1) for v in stats.values()])
    # jnp.median: the midpoint of the two middle values for an even count
    return torch.quantile(flat, 0.5, interpolation="midpoint")


def compute_directions(kind: str, sat: torch.Tensor,
                       gates: dict[str, torch.Tensor],
                       grad_stats: dict[str, torch.Tensor],
                       mag_stats: dict[str, torch.Tensor],
                       eps: float = 1e-12, clip: float | None = None):
    """Directions for every gate. ``sat`` is a bool tensor (no host
    sync)."""
    if kind not in DIRECTIONS:
        raise ValueError(f"direction {kind!r} not in {DIRECTIONS}")
    med = None
    if kind == "dir4":
        med = _global_median({k: grad_stats[k] + mag_stats[k]
                              for k in gates}) + eps
    dirs = {}
    for key, g in gates.items():
        gs = grad_stats[key].to(torch.float32)
        ms = mag_stats[key].to(torch.float32)
        ga = torch.abs(g.to(torch.float32))
        if kind == "dir1":
            unsat, satd = 1.0 / (gs + eps), -ga
        elif kind == "dir2":
            unsat, satd = 1.0 / (gs + ms + eps), -(ga + ms)
        elif kind == "dir3":
            unsat, satd = 1.0 / (gs + ms + eps), -(gs + ms)
        else:
            t = gs + ms
            unsat, satd = 1.0 / (1.0 + t / med), -t / (t + med)
        if clip is not None and kind != "dir4":
            unsat = torch.clamp(unsat, eps, clip)
            satd = -torch.clamp(-satd, 0.0, clip)
        d = torch.where(sat, satd, unsat)
        dirs[key] = torch.broadcast_to(d, g.shape).to(torch.float32)
    return dirs


def build_stats(gates: dict[str, torch.Tensor],
                probe_grads: dict[str, torch.Tensor | None],
                weight_stats: dict[str, torch.Tensor],
                act_stats: dict[str, dict[str, torch.Tensor]]):
    """``(grad_stats, mag_stats)`` keyed like ``gates``.

    ``probe_grads`` holds dL/dprobe for the weight (``*.w``) and activation
    (``*.a``) probes; a missing or None gradient (a probe the forward never
    used) counts as zero, as ``repro``'s zero gradient does.
    """
    grad_stats, mag_stats = {}, {}
    for key, g in gates.items():
        pg = probe_grads.get(key)
        if pg is None:
            gs = torch.zeros_like(g, dtype=torch.float32)
        else:
            gs = torch.abs(pg.to(torch.float32))
        if key.endswith(".w"):
            ms = weight_stats.get(key)
        else:
            ms = act_stats.get(key, {}).get("mean_abs")
        ms = torch.zeros((), device=g.device) if ms is None \
            else ms.to(torch.float32)
        mag_stats[key] = torch.broadcast_to(ms, g.shape)
        grad_stats[key] = torch.broadcast_to(gs, g.shape)
    return grad_stats, mag_stats


def check_direction_properties(dirs: dict[str, torch.Tensor],
                               sat: bool) -> bool:
    """Property (i)/(ii) checker used by tests and debug assertions."""
    return all(bool((v <= 0).all()) if sat else bool((v > 0).all())
               for v in dirs.values())
