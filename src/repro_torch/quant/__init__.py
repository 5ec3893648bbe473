"""The quantization representation from controller to kernel: ``spec``
(``QuantSpec``, ``ActQuantSpec``, ``QuantizedTensor``), ``pack`` (sub-byte
weight codes), ``export`` (``export_sites`` and ``export_act_sites`` with
their ``ExportLedger``), ``report`` (``quant_report``, the bytes/BOPs
ledger) and ``kv`` (the KV-cache codec)."""

from .export import (ActExportEntry, ExportLedger,  # noqa: F401
                     export_act_sites, export_sites)
from .kv import (KVQuantSpec, bytes_per_cached_token,  # noqa: F401
                 dequantize_kv, kv_cache_report, quantize_kv)
from .report import quant_report  # noqa: F401
from .spec import (ActQuantSpec, QuantizedTensor,  # noqa: F401
                   QuantSpec, specs_from_state)
