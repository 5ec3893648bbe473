"""The quantization representation from controller to kernel: ``spec``
(``QuantSpec``, ``QuantizedTensor``) and ``export`` (``export_sites`` with
its ``ExportLedger``)."""

from .export import ExportLedger, export_sites  # noqa: F401
from .spec import QuantizedTensor, QuantSpec, specs_from_state  # noqa: F401
