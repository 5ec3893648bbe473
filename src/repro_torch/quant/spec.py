"""QuantSpec / QuantizedTensor: the quantization representation that goes
from controller to kernel.

Counterpart of ``repro/quant/spec.py``. ``QuantSpec`` is one site's
frozen bits/range/sign; ``ActQuantSpec`` the per-tensor grid of one matmul
input (an ``.in`` site, DESIGN.md §16); ``QuantizedTensor`` is one frozen
weight: int8 codes ``(..., K, N)`` (8-bit class) or 2/4-bit codes packed
along K into uint8 ``(..., ceil(K/per), N)`` (``pack.py``), plus the affine
terms, with ``codes * scale + bias`` on the exact ``core.quantizer.quantize``
grid.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.gates import gate_to_bits
from repro_torch.core.quantizer import affine_grid, quantize_to_int

from .pack import pack_codes, unpack_codes

# Integer storage classes the serving path can carry (bits -> packed words).
STORAGE_CLASSES = (2, 4, 8)
SERVE_MIN_BITS = 2


def storage_class_for(max_bits: int) -> int | None:
    """Smallest 2/4/8-bit storage class holding ``max_bits``-bit codes, or
    ``None`` above the serving GEMM's 8-bit ceiling."""
    max_bits = max(int(max_bits), SERVE_MIN_BITS)
    for b in STORAGE_CLASSES:
        if max_bits <= b:
            return b
    return None


@dataclasses.dataclass
class QuantSpec:
    """Per-site quantization spec: gate-group shaped ``bits``/``beta``
    (leading stack axis for scan-stacked sites) and a static sign."""

    bits: torch.Tensor
    beta: torch.Tensor
    signed: bool

    @classmethod
    def from_gate(cls, gate, beta, signed: bool) -> "QuantSpec":
        """Freeze a trained gate into a spec: ``bits = T(max(g, 0.5))``."""
        return cls(bits=gate_to_bits(gate),
                   beta=torch.as_tensor(beta, dtype=torch.float32),
                   signed=bool(signed))

    def max_bits(self) -> int:
        """Largest bit-width in the spec (host sync; export time only)."""
        return int(self.bits.max().item())

    def storage_bits(self) -> int | None:
        return storage_class_for(self.max_bits())

    def layer(self, r: int) -> "QuantSpec":
        """Layer ``r`` of a scan-stacked spec."""
        return QuantSpec(bits=self.bits[r], beta=self.beta[r],
                         signed=self.signed)


@dataclasses.dataclass
class ActQuantSpec:
    """Per-TENSOR affine activation spec of a matmul input (an ``.in``
    site). ``bits`` and ``signed`` are host values, so the integer GEMM's
    code width is known without a sync; ``beta`` is the calibrated range, a
    tensor with a leading layer axis for scan-stacked sites."""

    bits: int
    beta: torch.Tensor
    signed: bool = True

    @classmethod
    def from_gate(cls, gate, beta, signed: bool) -> "ActQuantSpec":
        """Freeze a concrete activation gate (host sync; export time)."""
        bits = int(gate_to_bits(torch.as_tensor(gate)).max().item())
        return cls(bits=bits, beta=torch.as_tensor(beta, dtype=torch.float32),
                   signed=bool(signed))

    def affine(self):
        """``(scale, bias)`` of the grid: dequant = codes * scale + bias."""
        return affine_grid(self.bits, self.beta, self.signed)

    def zero_point(self) -> torch.Tensor:
        """Integer zero-point ``z`` with ``x ~ scale * (codes - z)``."""
        scale, bias = self.affine()
        return -bias / scale

    def layer(self, r: int) -> "ActQuantSpec":
        """Layer ``r`` of a scan-stacked spec."""
        return ActQuantSpec(bits=self.bits, beta=self.beta[r],
                            signed=self.signed)


def specs_from_state(gates: dict, betas: dict, signed: dict) -> dict:
    """Controller state -> one ``QuantSpec`` per gated key."""
    return {k: QuantSpec.from_gate(g, betas[k], signed[k])
            for k, g in gates.items()}


@dataclasses.dataclass
class QuantizedTensor:
    """One exported weight: (packed) integer codes + affine terms.

    ``codes`` is uint8 bit-packed ``(..., ceil(K/per), N)`` for 2/4-bit
    storage, int8 ``(..., K, N)`` for the 8-bit class (the unpacked oracle
    layout). ``scale``/``bias`` broadcast against the unpacked codes
    (``(..., 1, N)`` for per-channel sites); ``k`` is the logical fan-in;
    ``colsum`` is the int32 K-sum of the unpacked codes, frozen at export
    for the integer GEMM's zero-point correction.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    storage_bits: int
    k: int
    colsum: torch.Tensor | None = None

    @property
    def packed(self) -> bool:
        return self.storage_bits < 8

    @classmethod
    def from_float(cls, w, bits, beta, signed: bool, *, storage_bits: int,
                   pack: bool = True) -> "QuantizedTensor":
        """Freeze ``w`` on the ``bits`` grid into ``storage_bits`` storage.

        ``pack=False`` keeps the int8 oracle layout whatever the storage
        class: the packed path's equivalence reference.
        """
        codes, scale, bias = quantize_to_int(w, bits, beta, signed)
        colsum = codes.to(torch.int32).sum(dim=-2)
        k = int(w.shape[-2])
        # elementwise ops keep the strides of a transposed input (the tied
        # head's embed.T); the kernels read row-major codes
        codes = codes.to(torch.int8).contiguous()
        if pack and storage_bits < 8:
            return cls(codes=pack_codes(codes, storage_bits), scale=scale,
                       bias=bias, storage_bits=storage_bits, k=k,
                       colsum=colsum)
        return cls(codes=codes, scale=scale, bias=bias, storage_bits=8, k=k,
                   colsum=colsum)

    def layer(self, r: int) -> "QuantizedTensor":
        """Layer ``r`` of a scan-stacked export (contiguous views, no
        copy)."""
        return QuantizedTensor(
            codes=self.codes[r], scale=self.scale[r], bias=self.bias[r],
            storage_bits=self.storage_bits, k=self.k,
            colsum=None if self.colsum is None else self.colsum[r])

    def int8_codes(self) -> torch.Tensor:
        """Unpacked centered codes ``(..., K, N)`` int8 (oracle layout)."""
        if not self.packed:
            return self.codes
        return unpack_codes(self.codes, self.storage_bits, self.k)

    def code_colsum(self) -> torch.Tensor:
        """``(..., N)`` int32 K-sum of the unpacked codes."""
        if self.colsum is not None:
            return self.colsum
        return self.int8_codes().to(torch.int32).sum(dim=-2)

    def dequantize(self) -> torch.Tensor:
        """fp32 weight on the exact fake-quant grid."""
        return self.int8_codes().to(torch.float32) * self.scale + self.bias

    # ---- accounting (from shapes; no device sync) -------------------------
    def codes_bytes(self) -> int:
        """Device bytes of the code array (1 byte per stored word)."""
        return self.codes.numel()

    def aux_bytes(self) -> int:
        """Device bytes of the affine terms (fp32 scale + bias)."""
        return 4 * (self.scale.numel() + self.bias.numel())

    def weight_count(self) -> int:
        """Logical weight count (unpacked: stack x K x N)."""
        return math.prod(self.codes.shape[:-2]) * self.k * self.codes.shape[-1]
