"""Model-agnostic quantized-weight export (2/4/8-bit storage classes).

Counterpart of ``repro/quant/export.py:export_sites``. ``repro`` captures
each site's weight with an export-mode forward; the port takes the same
mapping ("<site>.w" -> stacked weight) from
``models.transformer.site_weights``. Every site lands in the
``ExportLedger``, exported or not, with the reason when it is not.
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
