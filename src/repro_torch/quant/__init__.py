"""The quantization representation from controller to kernel: ``spec``
(``QuantSpec``, ``QuantizedTensor``), ``pack`` (sub-byte weight codes),
``export`` (``export_sites`` with its ``ExportLedger``) and ``kv`` (the
KV-cache codec)."""

from .export import ExportLedger, export_sites  # noqa: F401
from .kv import (KVQuantSpec, bytes_per_cached_token,  # noqa: F401
                 dequantize_kv, kv_cache_report, quantize_kv)
from .spec import QuantizedTensor, QuantSpec, specs_from_state  # noqa: F401
