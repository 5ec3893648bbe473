"""Quantization primitives (paper Eq. 1), forward only.

Counterpart of ``repro/core/quantizer.py``. The quantizer maps ``x`` in
``[alpha, beta]`` onto a ``b``-bit uniform grid::

    Q(x, b, alpha, beta) = alpha + s * round((clip(x) - alpha) / s),
    s = (beta - alpha) / (2^b - 1)

Every step runs in float32 in the same order as ``repro``, and
``torch.round`` rounds half to even like ``jnp.round``, so codes, scales
and biases are bit-equal to ``repro``'s on the same inputs. The
straight-through ``fake_quant`` (an ``autograd.Function``) comes with the
training slice.
"""

from __future__ import annotations

import torch

# Quantization at >= this many bits is an exact pass-through in fp32.
PASSTHROUGH_BITS = 32


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def quantize(x: torch.Tensor, bits, beta, signed: bool) -> torch.Tensor:
    """Pure quantization. ``alpha = -beta`` if signed else ``0``.

    ``bits``/``beta`` broadcast against ``x``. ``bits >= 32`` passes
    through. Computes in fp32 and returns ``x``'s dtype.
    """
    out_dtype = x.dtype
    x = x.to(torch.float32)
    beta = torch.clamp_min(_f32(beta, x), 1e-8)
    alpha = -beta if signed else torch.zeros_like(beta)
    span = beta - alpha
    static = isinstance(bits, (int, float))
    if static:
        # A host-side width (the fixed input bits): decide the pass-through
        # on the host and fill ``n`` on the device. A scalar tensor copied
        # from the host would make the host wait for the card, and dividing
        # by a Python scalar would run on the card as a reciprocal multiply.
        if bits >= PASSTHROUGH_BITS:
            return x.to(out_dtype)
        n = torch.full_like(span, 2.0 ** min(max(float(bits), 2.0), 31.0)
                            - 1.0)
    else:
        bits = _f32(bits, x)
        # Clamp bits into [2, 31] for the arithmetic; pass-through below.
        n = torch.exp2(torch.clamp(bits, 2.0, 31.0)) - 1.0
    s = span / n
    xc = torch.minimum(torch.maximum(x, alpha), beta)
    q = alpha + s * torch.round((xc - alpha) / s)
    if not static:
        q = torch.where(bits >= PASSTHROUGH_BITS, x, q)
    return q.to(out_dtype)


def affine_grid(bits, beta, signed: bool):
    """The ``(scale, bias)`` of ``quantize_to_int``'s centered-code grid:
    ``codes * scale + bias`` reconstructs the quantized value."""
    beta = torch.clamp_min(torch.as_tensor(beta, dtype=torch.float32), 1e-8)
    alpha = -beta if signed else torch.zeros_like(beta)
    bits_f = _f32(bits, beta)
    n = torch.exp2(bits_f) - 1.0
    s = (beta - alpha) / n
    offset = torch.exp2(bits_f - 1.0)
    return s, alpha + offset * s


def quantize_to_int(x: torch.Tensor, bits, beta, signed: bool):
    """Export path: ``(codes, scale, bias)`` with ``codes * scale + bias``
    on the grid of ``quantize(x, bits, beta, signed)``.

    Codes are centered (``[-2^(b-1), 2^(b-1)-1]``); their dtype is int8 iff
    every element is <= 8 bits, else int32.
    """
    beta = torch.clamp_min(_f32(beta, x), 1e-8)
    alpha = -beta if signed else torch.zeros_like(beta)
    bits_f = _f32(bits, x)
    s, bias = affine_grid(bits_f, beta, signed)
    x = x.to(torch.float32)
    raw = torch.round((torch.minimum(torch.maximum(x, alpha), beta) - alpha) / s)
    codes = raw - torch.exp2(bits_f - 1.0)
    max_bits = bits if isinstance(bits, int) else int(bits_f.max().item())
    dtype = torch.int8 if max_bits <= 8 else torch.int32
    return codes.to(dtype), s, bias
