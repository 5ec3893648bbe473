"""The bytes/BOPs ledger of a served artifact (DESIGN.md §11, §16).

Counterpart of ``repro/quant/report.py``. CGMQ certifies a BOP budget at
training time; ``quant_report`` states what the deployed artifact costs:
per-site device bytes under packed sub-byte storage, which GEMM inputs
serve integer, and the model's BOPs, against fp32 and uniform-int8
baselines.
"""

from __future__ import annotations

from repro_torch.core import bop as bop_lib


def quant_report(ledger, gates: dict, kv: dict | None = None) -> dict:
    """Bytes + BOPs of an export vs fp32 and uniform-int8 baselines.

    ``ledger``: the ``ExportLedger`` of ``quant.export.export_sites`` (with
    ``act_entries`` from ``export_act_sites``); ``gates``: the gate dict the
    BOPs are certified from; ``kv``: an optional KV-cache section
    (``quant.kv.kv_cache_report``).

    Returns a plain dict with ``repro``'s sections and keys:
      per_site:  key -> {served, bits, storage_bits, reason, bytes,
                 weight_count}
      totals:    weight_count, bytes_packed, bytes_aux, bytes_device,
                 bytes_uniform_int8, bytes_fp32, bytes_per_weight,
                 uniform_int8_bytes_per_weight, packed_vs_int8,
                 packed_vs_fp32, fallback_sites, exported_sites
      acts:      total, covered, fallback_sites, bits (per ``.in`` key)
      bops:      model, fp32, uniform_int8, rbop
      kv_cache:  ``kv``, when given.

    The uniform-int8 baseline is every exported site at one byte per code
    with the same affine terms, and fallback sites at their fp32 bytes.
    """
    per_site = {}
    total_w = 0
    bytes_packed = 0
    bytes_aux = 0
    bytes_int8 = 0
    for key, e in ledger.entries.items():
        n = e["weight_count"]
        total_w += n
        if e["served"] == "int":
            site_bytes = e["codes_bytes"]
            bytes_aux += e["aux_bytes"]
            bytes_int8 += n
        else:
            site_bytes = e["fp_bytes"]
            bytes_int8 += e["fp_bytes"]
        bytes_packed += site_bytes
        per_site[key] = {
            "served": e["served"],
            "bits": e["bits"],
            "storage_bits": e.get("storage_bits"),
            "reason": e.get("reason"),
            "bytes": site_bytes + e.get("aux_bytes", 0),
            "weight_count": n,
        }
    sites = ledger.sites
    bops_fp32 = bop_lib.fp32_bop(sites)
    bops_int8 = sum(s.macs_per_token * s.stack * 8.0 * 8.0
                    for s in sites.values() if s.act_quantized)
    bops_model = float(bop_lib.model_bop(sites, gates)) if gates else 0.0
    bytes_device = bytes_packed + bytes_aux
    bytes_uniform_int8 = bytes_int8 + bytes_aux
    totals = {
        "weight_count": total_w,
        "bytes_packed": bytes_packed,
        "bytes_aux": bytes_aux,
        "bytes_device": bytes_device,
        "bytes_uniform_int8": bytes_uniform_int8,
        "bytes_fp32": 4 * total_w,
        "bytes_per_weight": bytes_device / max(total_w, 1),
        "uniform_int8_bytes_per_weight": bytes_uniform_int8 / max(total_w, 1),
        "packed_vs_int8": bytes_device / max(bytes_uniform_int8, 1),
        "packed_vs_fp32": bytes_device / max(4 * total_w, 1),
        "fallback_sites": len(ledger.fallbacks()),
        "exported_sites": len(ledger.exported()),
    }
    # which GEMMs run integer MACs: covered == total means every
    # quantized-output matmul serves int8 x int8
    act_entries = ledger.act_entries
    acts = {
        "total": sum(1 for e in act_entries.values()
                     if e.served != "excluded"),
        "covered": len(ledger.act_exported()),
        "fallback_sites": sorted(k for k, e in act_entries.items()
                                 if e.served == "fake_quant"),
        "bits": {k: e.bits for k, e in act_entries.items()
                 if e.served == "int"},
    }
    out = {
        "per_site": per_site,
        "totals": totals,
        "acts": acts,
        "bops": {
            "model": bops_model,
            "fp32": bops_fp32,
            "uniform_int8": bops_int8,
            "rbop": bops_model / bops_fp32 if bops_fp32 else 0.0,
        },
    }
    if kv is not None:
        out["kv_cache"] = kv
    return out
