"""Sub-byte bit packing for quantized weight codes (DESIGN.md §11).

Counterpart of ``repro/quant/pack.py`` (``CODES_PER_BYTE``, ``packed_rows``,
``pack_codes``, ``unpack_codes``; the blockwise int8 codec comes with ROADMAP
queue 1 item 16). 2- and 4-bit codes are packed along the K (fan-in) axis,
so a b-bit site holds ``ceil(K * b / 8)`` bytes per output channel.

Layout (read by the packed ``quant_matmul`` kernel, K4): byte ``i`` of a
column holds codes ``i*per + j`` for ``j in 0..per-1`` (``per = 8 // bits``),
code ``j`` in bits ``[j*b, (j+1)*b)`` -- little-endian within the byte.
Codes are stored biased by ``2^(b-1)`` (unsigned); unpacking subtracts the
offset. A ragged K tail is zero-padded; ``unpack_codes`` slices it off and
the kernel zeroes the matching activation columns instead. Any leading
stack dims ride along: scan-stacked layers pack as ``(reps, Kp, N)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Codes per packed byte for each sub-byte storage class.
CODES_PER_BYTE = {2: 4, 4: 2, 8: 1}


def packed_rows(k: int, bits: int) -> int:
    """Packed K-axis length: ``ceil(k / (8 // bits))``."""
    per = CODES_PER_BYTE[bits]
    return -(-k // per)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack centered int codes (..., K, N) into uint8 (..., ceil(K/per), N).

    ``bits`` in {2, 4}; values must lie in ``[-2^(b-1), 2^(b-1)-1]``. The
    result is a new contiguous tensor whatever the strides of ``codes``.
    """
    if bits not in (2, 4):
        raise ValueError(f"pack_codes packs 2 or 4 bits, got {bits}")
    per = CODES_PER_BYTE[bits]
    k = codes.shape[-2]
    pad = (-k) % per
    biased = (codes.to(torch.int32) + (1 << (bits - 1))).to(torch.uint8)
    if pad:
        biased = F.pad(biased, (0, 0, 0, pad))  # tail never unpacked
    kp = (k + pad) // per
    grouped = biased.reshape(*biased.shape[:-2], kp, per, biased.shape[-1])
    out = torch.zeros(grouped.shape[:-2] + grouped.shape[-1:],
                      dtype=torch.uint8, device=codes.device)
    for j in range(per):
        out |= grouped[..., j, :] << (j * bits)
    return out


def unpack_codes(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_codes``: uint8 (..., Kp, N) -> int8 (..., k, N)."""
    if bits not in (2, 4):
        raise ValueError(f"unpack_codes unpacks 2 or 4 bits, got {bits}")
    per = CODES_PER_BYTE[bits]
    mask = (1 << bits) - 1
    p = packed.to(torch.int32)
    stacked = torch.stack([(p >> (j * bits)) & mask for j in range(per)],
                          dim=-2)                       # (..., Kp, per, N)
    flat = stacked.reshape(*stacked.shape[:-3], stacked.shape[-3] * per,
                           stacked.shape[-1])
    return (flat[..., :k, :] - (1 << (bits - 1))).to(torch.int8)
