"""BOP (bit-operations) cost model (paper §2.5).

Counterpart of ``repro/core/bop.py``. For a dense layer the paper's cost is
``BOP(l) = < sum_j b_W[j, :], b_a >``: per output activation, its
bit-width times the sum of the bit-widths of the weights that produce it.
With per-tensor gates that is ``MACs * b_w * b_a``. Sites whose output
stays floating point (the head) count for nothing, in the quantized and
the fp32 totals alike; MoE sites scale by ``active_frac``; the attention
score/value products have no weight operand and are not constrained.

Gate shapes per granularity (leading ``stack`` dim for stacked sites):
per-tensor ``()``/``(k,)``; per-channel ``(O,)``/``(k, O)``; per-weight
``weight_shape``/``(k, *weight_shape)``, output axis last. Everything stays
on the gates' device: no host sync.
"""

from __future__ import annotations

import torch

from .gates import gate_to_bits
from .sites import SiteInfo

FP_BITS = 32.0


def _per_out_weight_bits(bw: torch.Tensor, site: SiteInfo) -> torch.Tensor:
    """``sum_j b_W[j, o]`` per output channel; keeps a stack dim if
    present. Shape (), (k,), (O,) or (k, O)."""
    fan_in = float(site.fan_in)
    stacked = site.stack > 1 and bw.ndim >= 1
    core = tuple(bw.shape[1:] if stacked else bw.shape)
    if core in ((), (site.out_features,)):   # per-tensor, per-channel
        return fan_in * bw
    # per-weight: output axis last; sum every other non-stack axis
    red = tuple(range(1, bw.ndim - 1)) if stacked else tuple(
        range(bw.ndim - 1))
    return bw.sum(dim=red)


def site_bop(site: SiteInfo, w_gate: torch.Tensor | None,
             a_gate: torch.Tensor | None) -> torch.Tensor:
    """BOP of one site from its gates (either may be None -> fp32 bits)."""
    like = w_gate if w_gate is not None else a_gate
    dev = None if like is None else like.device
    if not site.act_quantized:
        return torch.zeros((), dtype=torch.float32, device=dev)
    fp = torch.full((), FP_BITS, device=dev)
    bw = gate_to_bits(w_gate) if w_gate is not None else fp
    ba = gate_to_bits(a_gate) if a_gate is not None else fp
    k = site.stack
    wsum = _per_out_weight_bits(bw, site)

    def kind(arr):
        """'scalar' (per-tensor view), 'stack', 'chan' or 'stack_chan'."""
        if arr.ndim == 0:
            return "scalar"
        if k > 1 and arr.shape[0] == k:
            return "stack" if arr.ndim == 1 else "stack_chan"
        return "chan"

    def lift(arr, kd):       # align to the (stack, chan) broadcast space
        if kd == "scalar":
            return arr.reshape(1, 1)
        if kd == "stack":
            return arr.reshape(-1, 1)
        if kd == "chan":
            return arr.reshape(1, -1)
        return arr

    kw, ka = kind(wsum), kind(ba)
    total = torch.sum(lift(wsum, kw) * lift(ba, ka))
    # multiply out the dims that stayed broadcast-collapsed
    if kw in ("scalar", "stack") and ka in ("scalar", "stack"):
        total = total * float(site.out_features)
    if kw == "scalar" and ka in ("scalar", "chan") and k > 1:
        # metadata says stacked but the gates carry no stack dim
        total = total * k
    return total * float(site.positions) * float(site.active_frac)


def activation_gate(gates: dict[str, torch.Tensor], name: str):
    """The gate carrying a site's GEMM activation width: the ``.in`` input
    gate if the state has one, else the ``.a`` output gate, else None."""
    ag = gates.get(name + ".in")
    return gates.get(name + ".a") if ag is None else ag


def model_bop(sites: dict[str, SiteInfo],
              gates: dict[str, torch.Tensor]) -> torch.Tensor:
    """Total BOP of the model under the current gates."""
    dev = next(iter(gates.values())).device if gates else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in sites.values():
        total = total + site_bop(s, gates.get(s.name + ".w"),
                                 activation_gate(gates, s.name))
    return total


def fp32_bop(sites: dict[str, SiteInfo]) -> float:
    """BOP of the all-32-bit model (the RBOP denominator). Static."""
    return sum(s.macs_per_token * s.stack * FP_BITS * FP_BITS
               for s in sites.values() if s.act_quantized)


def min_bop(sites: dict[str, SiteInfo]) -> float:
    """All-2-bit lower bound (no pruning: b >= 2)."""
    return sum(s.macs_per_token * s.stack * 2.0 * 2.0
               for s in sites.values() if s.act_quantized)


def rbop(sites: dict[str, SiteInfo], gates: dict[str, torch.Tensor]):
    """Relative BOP: quantized cost / fp32 cost (paper §4.2)."""
    return model_bop(sites, gates) / fp32_bop(sites)


def budget_from_rbop(sites: dict[str, SiteInfo], rbop_bound: float) -> float:
    """Absolute BOP budget from a relative bound (e.g. 0.004 = 0.4%)."""
    return float(rbop_bound) * fp32_bop(sites)
