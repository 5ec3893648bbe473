"""Model-agnostic quantized-weight export (2/4/8-bit storage classes).

Counterpart of ``repro/quant/export.py``. ``repro`` captures each site's
weight with an export-mode forward; the port takes the same mapping
("<site>.w" -> stacked weight) from ``models.transformer.site_weights``.
Every site lands in the ``ExportLedger``, exported or not, with the reason
when it is not; ``export_act_sites`` ledgers every matmul input the same
way (DESIGN.md §16), so no site serves float GEMM inputs unseen.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.core.gates import gate_to_bits

from .spec import QuantizedTensor, storage_class_for


@dataclasses.dataclass
class ExportLedger:
    """Per-site record of what the export did (one entry per ``.w`` key).

    Entry fields: ``served`` ("int" | "fake_quant"), ``bits``,
    ``storage_bits`` (exported sites), ``reason`` (fallback sites:
    "bits>8" | "granularity" | "shape" | "ungated"), ``weight_count`` and
    ``codes_bytes``/``aux_bytes`` (exported) or ``fp_bytes`` (fallback).
    """

    entries: dict[str, dict] = dataclasses.field(default_factory=dict)
    sites: dict[str, Any] = dataclasses.field(default_factory=dict)
    act_entries: dict[str, "ActExportEntry"] = dataclasses.field(
        default_factory=dict)

    def exported(self) -> dict[str, dict]:
        return {k: e for k, e in self.entries.items() if e["served"] == "int"}

    def fallbacks(self) -> dict[str, dict]:
        return {k: e for k, e in self.entries.items()
                if e["served"] == "fake_quant"}

    # ---- activation (".in") sites (DESIGN.md §16) -------------------------
    def act_exported(self) -> dict[str, "ActExportEntry"]:
        return {k: e for k, e in self.act_entries.items()
                if e.served == "int"}

    def act_fallbacks(self) -> dict[str, "ActExportEntry"]:
        return {k: e for k, e in self.act_entries.items()
                if e.served != "int"}


@dataclasses.dataclass
class ActExportEntry:
    """One activation (``.in``) site in the ledger.

    ``served`` is "int" (the site's GEMM runs int8 x int8 against this
    per-tensor grid), "fake_quant" (no calibrated spec: the GEMM input stays
    float, visible as weight fallbacks are) or "excluded" (the site's
    activation is unquantized by design). ``scale``/``zero_point`` carry a
    leading stack axis for scan-stacked sites.
    """

    served: str
    bits: int | None = None
    scale: Any = None
    zero_point: Any = None
    reason: str | None = None


def export_act_sites(act_specs: dict, sites: dict, *,
                     warn: bool = True) -> dict[str, ActExportEntry]:
    """Ledger every matmul site's input-activation quantization.

    ``act_specs`` maps "<site>.in" -> ``ActQuantSpec``; ``sites`` is the
    ``SiteInfo`` map. Every site gets an entry: served integer grids with
    their scale and zero-point; sites without a spec as fallbacks (with a
    ``UserWarning``), or as excluded when their activation is unquantized.
    """
    entries: dict[str, ActExportEntry] = {}
    for name, site in sites.items():
        key = name + ".in"
        spec = act_specs.get(key)
        if spec is not None:
            scale, _ = spec.affine()
            entries[key] = ActExportEntry(
                served="int", bits=int(spec.bits), scale=scale,
                zero_point=spec.zero_point())
        elif getattr(site, "act_quantized", True):
            entries[key] = ActExportEntry(served="fake_quant",
                                          reason="no_act_spec")
        else:
            entries[key] = ActExportEntry(served="excluded",
                                          reason="act_unquantized_site")
    missing = sorted(k for k, e in entries.items()
                     if e.served == "fake_quant")
    if warn and act_specs and missing:
        warnings.warn(
            f"act export: {len(missing)} matmul site(s) have no calibrated "
            f"activation spec and will serve float GEMM inputs: "
            f"{missing[:4]}{'...' if len(missing) > 4 else ''}",
            UserWarning, stacklevel=2)
    return entries


def _expand_group(a, w, stacked: bool):
    """Broadcast a gate-group array (() or (N,), plus a leading stack axis
    when ``stacked``) against weight ``w``; channels align with w's last
    axis."""
    a = torch.as_tensor(a, dtype=torch.float32)
    if stacked:
        core = tuple(a.shape[1:])
        return a.reshape((a.shape[0],) + (1,) * (w.ndim - 1 - len(core))
                         + core)
    if a.ndim == 0:
        return a
    return a.reshape((1,) * (w.ndim - a.ndim) + tuple(a.shape))


def export_sites(weights: dict, sites: dict, gates: dict, betas: dict,
                 signed: dict, *, pack: bool = True, warn: bool = True):
    """Freeze every eligible site of ``weights`` ("<site>.w" -> tensor);
    ledger all of them. Codes are stored at the site's 2/4/8-bit storage
    class, packed sub-byte when ``pack``; ``pack=False`` keeps the unpacked
    int8 oracle layout. Returns ``(qweights, ledger)``."""
    qweights: dict[str, QuantizedTensor] = {}
    ledger = ExportLedger(sites=dict(sites))
    for key, w in weights.items():
        site = sites.get(key[: -len(".w")])
        if site is None:
            continue
        count = w.numel()
        if key not in gates:
            ledger.entries[key] = {"served": "fake_quant", "bits": None,
                                   "reason": "ungated", "weight_count": count,
                                   "fp_bytes": 4 * count}
            continue
        g = gates[key]
        bits = gate_to_bits(g)
        max_bits = int(bits.max().item())
        entry = {"served": "fake_quant", "bits": max_bits,
                 "weight_count": count, "fp_bytes": 4 * count}
        ledger.entries[key] = entry
        if len(site.weight_shape) != 2:
            entry["reason"] = "shape"
            continue
        stacked = w.ndim == len(site.weight_shape) + 1
        core = tuple(g.shape[1:] if stacked else g.shape)
        if core not in ((), (w.shape[-1],)):
            entry["reason"] = "granularity"
            continue
        if stacked and (g.ndim == 0 or g.shape[0] != w.shape[0]):
            entry["reason"] = "granularity"
            continue
        storage = storage_class_for(max_bits)
        if storage is None:
            entry["reason"] = "bits>8"
            continue
        qt = QuantizedTensor.from_float(
            w, _expand_group(bits, w, stacked),
            _expand_group(betas[key], w, stacked), bool(signed[key]),
            storage_bits=storage, pack=pack)
        qweights[key] = qt
        entry.update(served="int", storage_bits=qt.storage_bits,
                     codes_bytes=qt.codes_bytes(), aux_bytes=qt.aux_bytes())
        del entry["fp_bytes"]
    high = [k for k, e in ledger.entries.items()
            if e.get("reason") in ("bits>8", "ungated")]
    if warn and high:
        warnings.warn(
            f"export: {len(high)} site(s) (trained above 8 bits, or absent "
            f"from the quant state) keep full-precision weights on device: "
            f"{sorted(high)[:4]}{'...' if len(high) > 4 else ''}",
            UserWarning, stacklevel=2)
    return qweights, ledger
