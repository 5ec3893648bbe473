"""The CGMQ constraint controller (paper §2.2-2.3 and the guarantee of §3).

Counterpart of ``repro/core/controller.py``. The Sat/Unsat flag is
evaluated on the total BOP count once per check window (``check_every``
steps) and applies to the NEXT window (it lags, as in the paper); every
step, directions come from the current flag and gates take one plain SGD
step ``g <- clamp(g - lr * dir)``. Whenever a check certifies the budget,
the gates are snapshotted: the deployable artifact is the last certified
snapshot (``export_gates``), which is what makes the §3 guarantee hold at
export time.

The state is a dataclass of tensors and every update stays on the gates'
device: ``controller_update`` never syncs the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import bop as bop_lib
from .directions import build_stats, compute_directions
from .gates import clamp_gate, gate_to_bits
from .sites import SiteInfo


@dataclasses.dataclass(frozen=True)
class CGMQConfig:
    budget_rbop: float = 0.004      # relative BOP bound (paper: 0.4%..5%)
    direction: str = "dir1"
    gate_lr: float = 0.01           # paper: 0.01 for dir1/dir2
    check_every: int | None = None  # None: check every step
    dir_clip: float | None = None   # bound the Unsat direction
    eps: float = 1e-12


@dataclasses.dataclass
class CGMQState:
    gates: dict[str, torch.Tensor]
    sat: torch.Tensor          # bool scalar, lagged constraint flag
    bop: torch.Tensor          # BOP at the last check
    step: torch.Tensor         # int32 step counter
    best_gates: dict[str, torch.Tensor]   # last constraint-satisfying snapshot
    best_valid: torch.Tensor   # bool: a satisfying snapshot exists


def init_state(gates: dict[str, torch.Tensor],
               sites: dict[str, SiteInfo]) -> CGMQState:
    dev = next(iter(gates.values())).device
    return CGMQState(
        gates=gates,
        sat=torch.zeros((), dtype=torch.bool, device=dev),
        bop=bop_lib.model_bop(sites, gates),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        best_gates={k: v.clone() for k, v in gates.items()},
        best_valid=torch.zeros((), dtype=torch.bool, device=dev))


def controller_update(state: CGMQState, cfg: CGMQConfig,
                      sites: dict[str, SiteInfo],
                      probe_grads: dict[str, torch.Tensor | None],
                      weight_stats: dict[str, torch.Tensor],
                      act_stats: dict[str, dict[str, torch.Tensor]],
                      budget_bop: float) -> CGMQState:
    """One CGMQ gate update. Returns a new state; the old one is kept."""
    grad_stats, mag_stats = build_stats(state.gates, probe_grads,
                                        weight_stats, act_stats)
    dirs = compute_directions(cfg.direction, state.sat, state.gates,
                              grad_stats, mag_stats, eps=cfg.eps,
                              clip=cfg.dir_clip)
    new_gates = {k: clamp_gate(g - cfg.gate_lr * dirs[k])
                 for k, g in state.gates.items()}
    step = state.step + 1
    # re-evaluate Sat at the end of each check window; the flag applies to
    # the NEXT window
    due = (step % (cfg.check_every or 1)) == 0
    cost = bop_lib.model_bop(sites, new_gates)
    ok = cost <= budget_bop
    take = due & ok
    return CGMQState(
        gates=new_gates,
        sat=torch.where(due, ok, state.sat),
        bop=torch.where(due, cost, state.bop),
        step=step,
        best_gates={k: torch.where(take, new_gates[k], state.best_gates[k])
                    for k in new_gates},
        best_valid=state.best_valid | take)


def export_gates(state: CGMQState) -> dict[str, torch.Tensor]:
    """The deployable gate set: the last certified snapshot if one
    exists (host sync)."""
    return state.best_gates if bool(state.best_valid) else state.gates


def guarantee_satisfied(state: CGMQState, sites: dict[str, SiteInfo],
                        budget_bop: float) -> bool:
    """Hard check at export time: does the exported model meet B_BOP?"""
    cost = float(bop_lib.model_bop(sites, export_gates(state)))
    return cost <= budget_bop + 1e-6


def export_bits(state: CGMQState) -> dict[str, Any]:
    """Freeze gates into integer bit-widths for deployment (numpy)."""
    return {k: gate_to_bits(g).cpu().numpy().astype("int32")
            for k, g in export_gates(state).items()}
